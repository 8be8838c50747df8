"""NYU-40 / ScanNet colour palettes and class-remap tables (a copy of the
JAX package's viz/colormaps.py: the standard public ScanNet benchmark
palette data, ref: nr4seg/dataset/ngp_utils.py:73-115,
nr4seg/visualizer/colormaps.py:6-51, scripts/eval_utils.py:4-152). Index 0
is "unlabeled"; classes 1..40 are the NYU-40 categories, so a label image
stored as `class + 1` indexes directly.
"""

import numpy as np

# (name, (r, g, b)) for unlabeled + the 40 NYU classes.
_SCANNET_PALETTE = [
    ("unlabeled", (0, 0, 0)),
    ("wall", (174, 199, 232)),
    ("floor", (152, 223, 138)),
    ("cabinet", (31, 119, 180)),
    ("bed", (255, 187, 120)),
    ("chair", (188, 189, 34)),
    ("sofa", (140, 86, 75)),
    ("table", (255, 152, 150)),
    ("door", (214, 39, 40)),
    ("window", (197, 176, 213)),
    ("bookshelf", (148, 103, 189)),
    ("picture", (196, 156, 148)),
    ("counter", (23, 190, 207)),
    ("blinds", (178, 76, 76)),
    ("desk", (247, 182, 210)),
    ("shelves", (66, 188, 102)),
    ("curtain", (219, 219, 141)),
    ("dresser", (140, 57, 197)),
    ("pillow", (202, 185, 52)),
    ("mirror", (51, 176, 203)),
    ("floormat", (200, 54, 131)),
    ("clothes", (92, 193, 61)),
    ("ceiling", (78, 71, 183)),
    ("books", (172, 114, 82)),
    ("refrigerator", (255, 127, 14)),
    ("television", (91, 163, 138)),
    ("paper", (153, 98, 156)),
    ("towel", (140, 153, 101)),
    ("showercurtain", (158, 218, 229)),
    ("box", (100, 125, 154)),
    ("whiteboard", (178, 127, 135)),
    ("person", (120, 185, 128)),
    ("nightstand", (146, 111, 194)),
    ("toilet", (44, 160, 44)),
    ("sink", (112, 128, 144)),
    ("lamp", (96, 207, 209)),
    ("bathtub", (227, 119, 194)),
    ("bag", (213, 92, 176)),
    ("otherstructure", (94, 106, 211)),
    ("otherfurniture", (82, 84, 163)),
    ("otherprop", (100, 85, 144)),
]

SCANNET_CLASS_NAMES = [name for name, _ in _SCANNET_PALETTE]
SCANNET_COLORS = [rgb for _, rgb in _SCANNET_PALETTE]
SCANNET_CLASSES = list(range(len(_SCANNET_PALETTE)))

# uint8 (41, 3) palette; NYU40_COLOUR_CODE[label + 1] colorizes a 0-39 label
# map with -1 → black (ref: nr4seg/dataset/ngp_utils.py:73).
NYU40_COLOUR_CODE = np.array(SCANNET_COLORS, dtype=np.uint8)

# NYU-13 palette (standard benchmark colors; ref: scripts/eval_utils.py:47-64)
# order: unlabeled, bed, books, ceiling, chair, floor, furniture, objects,
# painting, sofa, table, tv, wall, window
NYU13_COLOUR_CODE = (np.array([
    [0, 0, 0],
    [0, 0, 1],
    [0.9137, 0.3490, 0.1882],
    [0, 0.8549, 0],
    [0.5843, 0, 0.9412],
    [0.8706, 0.9451, 0.0941],
    [1.0000, 0.8078, 0.8078],
    [0, 0.8784, 0.8980],
    [0.4157, 0.5333, 0.8000],
    [0.4588, 0.1137, 0.1608],
    [0.9412, 0.1373, 0.9216],
    [0, 0.6549, 0.6118],
    [0.9765, 0.5451, 0],
    [0.8824, 0.8980, 0.7608],
]) * 255).astype(np.uint8)

# NYU-40 id → NYU-13 id remap table (standard benchmark mapping;
# ref: scripts/eval_utils.py:66-152). Index 0 = unlabeled.
NYU40_TO_13 = np.array([
    0, 12, 5, 6, 1, 4, 9, 10, 12, 13, 6, 8, 6, 13, 10, 6, 13, 6, 7, 7, 5, 7,
    3, 2, 6, 11, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 6, 7
], dtype=np.int32)
