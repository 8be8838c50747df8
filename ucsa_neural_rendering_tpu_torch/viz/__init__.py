from .colormaps import (NYU13_COLOUR_CODE, NYU40_COLOUR_CODE,
                        SCANNET_CLASS_NAMES, SCANNET_CLASSES, SCANNET_COLORS,
                        NYU40_TO_13)
from .visualizer import Visualizer, colorize_label

__all__ = [
    "NYU13_COLOUR_CODE", "NYU40_COLOUR_CODE", "SCANNET_CLASS_NAMES",
    "SCANNET_CLASSES", "SCANNET_COLORS", "NYU40_TO_13", "Visualizer",
    "colorize_label"
]
