"""Image files for the data layer, without cv2 or imageio (the JAX package
reads and writes them with cv2, imageio or its native loader).

  * PNG in numpy + zlib: non-interlaced grey, RGB and RGBA at bit depths 8
    and 16 (16-bit samples are big-endian in the file; depth maps are
    uint16 millimetres). The reader takes all five row filters; paletted,
    grey+alpha and interlaced files and other bit depths raise. The writer
    uses the Up filter on every row, so that reading its own files needs no
    per-pixel loop.
  * JPEG through the first decoder that imports of torchvision.io, PIL and
    cv2, imported inside the function (ImportError naming them when none
    is installed); always RGB.
  * The datasets' resizes, as cv2 does them: INTER_AREA for images
    (a box mean over each output pixel's footprint, downscaling only),
    INTER_LINEAR for the ScanNet-25k frames' rescale (two taps at pixel
    centres, no antialiasing), INTER_NEAREST for labels and depth (source
    index floor(x · src / dst) by cv2's rule).

Arrays are HWC (or HW), RGB order, as the PNG stores them; cv2 would give
BGR.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


# ------------------------------------------------------------------- PNG
def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _paeth_row(line, prior, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line, prior, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines → [H, stride] bytes."""
    ftype, rows = raw[:, 0], raw[:, 1:]
    if (ftype == 0).all():
        return rows.copy()
    if (ftype == 2).all():  # Up on every row: a running sum down the rows
        return np.cumsum(rows, axis=0, dtype=np.uint8)
    out = np.empty_like(rows)
    prior = np.zeros(rows.shape[1], np.uint8)
    for y, f in enumerate(ftype):
        line = rows[y]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum along the row, pixel by pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prior
        elif f == 3:
            cur = _average_row(line.tobytes(), prior.tolist(), bpp)
        elif f == 4:
            cur = _paeth_row(line.tobytes(), prior.tolist(), bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 or uint16 array [H, W] (grey), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError("paletted PNGs are not supported")
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color} is not supported (grey, "
                         f"RGB and RGBA are)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 and 16 "
                         f"are)")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    ch, nbytes = _CHANNELS[color], depth // 8
    bpp = ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data has the wrong size")
    rows = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    img = rows if nbytes == 1 else \
        np.ascontiguousarray(rows).view(">u2").astype(np.uint16)
    return img.reshape((h, w) if ch == 1 else (h, w, ch))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 or uint16 array [H, W], [H, W, 3] or [H, W, 4] → PNG bytes
    (the Up filter on every row, zlib at `level`)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not "
                         f"{img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or ch not in _COLOR_TYPE:
        raise ValueError(f"PNG takes [H, W], [H, W, 3] or [H, W, 4], not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if img.dtype == np.uint16
                                else img).view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.empty((h, 1 + up.shape[1]), np.uint8)
    raw[:, 0] = 2
    raw[:, 1:] = up

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    depth = 8 * img.dtype.itemsize
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray, level: int = 1):
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------------ JPEG
def _jpeg_library():
    """The first of torchvision.io, PIL and cv2 that imports."""
    try:
        import torchvision.io
        return "torchvision"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401
        return "PIL"
    except ImportError:
        pass
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        pass
    raise ImportError("reading or writing a JPEG needs one of torchvision, "
                      "PIL (Pillow) or cv2 (opencv-python); none is "
                      "installed")


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file → uint8 [H, W, 3] RGB."""
    lib = _jpeg_library()
    if lib == "torchvision":
        import torchvision.io as tvio
        img = tvio.decode_jpeg(tvio.read_file(path),
                               mode=tvio.ImageReadMode.RGB)
        return img.permute(1, 2, 0).contiguous().numpy()
    if lib == "PIL":
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"cv2 could not read {path}")
    return np.ascontiguousarray(img[..., ::-1])


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 98):
    """uint8 [H, W, 3] RGB → a JPEG file at `quality`."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    lib = _jpeg_library()
    if lib == "torchvision":
        import torch
        import torchvision.io as tvio
        tvio.write_jpeg(torch.from_numpy(rgb).permute(2, 0, 1).contiguous(),
                        path, quality=quality)
    elif lib == "PIL":
        from PIL import Image
        Image.fromarray(rgb).save(path, quality=quality)
    else:
        import cv2
        if not cv2.imwrite(path, rgb[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality]):
            raise ValueError(f"cv2 could not write {path}")


def read_image(path: str) -> np.ndarray:
    """A PNG (read as stored) or a JPEG (uint8 RGB), told apart by the
    file's first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    return read_jpeg(path)


def read_rgb(path: str) -> np.ndarray:
    """An RGB(A) PNG or a JPEG → uint8 [H, W, 3] RGB (alpha dropped)."""
    img = read_image(path)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit RGB image, got "
                         f"{img.dtype} {img.shape}")
    return img[..., :3]


# --------------------------------------------------------------- resizes
def resize_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(..., INTER_NEAREST): output pixel x reads source pixel
    min(floor(x · (1 / (dst / src))), src − 1), per axis."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    if (h, w) == (oh, ow):
        return img

    def index(n_out, n_in):
        scale = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64),
                          n_in - 1)

    return img[index(oh, h)[:, None], index(ow, w)[None, :]]


def _area_weights(n_out, n_in):
    """[n_out, n_in]: each output cell's overlap with each source pixel
    over the cell's width (the footprint scale = n_in / n_out, cut at the
    image's end)."""
    scale = n_in / n_out
    lo = np.arange(n_out)[:, None] * scale
    hi = np.minimum(lo + scale, n_in)
    src = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(hi, src + 1) - np.maximum(lo, src), 0, None)
    return overlap / (hi - lo)


def resize_area(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(..., INTER_AREA) of a float image [H, W] or [H, W, C] to
    a size no larger: each output pixel is the mean over its footprint
    (at an integer factor, the mean of its block). Raises for an
    upscale."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    if (h, w) == (oh, ow):
        return img
    if oh > h or ow > w:
        raise ValueError(f"resize_area downscales only: {h}x{w} → {oh}x{ow}")
    dtype = img.dtype
    if h % oh == 0 and w % ow == 0:
        fy, fx = h // oh, w // ow
        block = img.reshape(oh, fy, ow, fx, *img.shape[2:])
        return (block.sum(axis=(1, 3), dtype=dtype)
                * dtype.type(1.0 / (fy * fx)))
    out = np.einsum("yh,hw...->yw...", _area_weights(oh, h),
                    img.astype(np.float64))
    out = np.einsum("xw,yw...->yx...", _area_weights(ow, w), out)
    return out.astype(dtype)


def _linear_taps(n_out: int, n_in: int):
    """cv2.resize INTER_LINEAR's taps along one axis: the source position
    (d + 0.5) · n_in / n_out − 0.5 in doubles (pixel centres, no
    antialiasing when shrinking), its floor and the floor's right
    neighbour, both clamped into the image, and the right tap's weight
    (the position's fraction, rounded to f32 only then: at a source
    position past 1024 an f32 position would move it by 6e-5). The scale
    is cv2's 1 / (n_out / n_in)."""
    scale = 1.0 / (n_out / n_in)
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(pos)
    frac = (pos - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    hi = np.clip(lo + 1, 0, n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    return lo, hi, np.where(lo == hi, np.float32(0.0), frac)


def resize_linear(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (ow, oh), interpolation=INTER_LINEAR) of an f32
    image [H, W] or [H, W, C]: separable two-tap blends, no antialiasing
    when shrinking, edge taps clamped (within a few f32 ulps of cv2's,
    which blends the rows of each output row's two source rows in another
    order)."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    if (h, w) == (oh, ow):
        return img
    img = np.asarray(img, np.float32)
    trail = (1,) * (img.ndim - 2)
    y0, y1, fy = _linear_taps(oh, h)
    x0, x1, fx = _linear_taps(ow, w)
    fy = fy.reshape(-1, 1, *trail)
    rows = img[y0] * (1 - fy) + img[y1] * fy
    fx = fx.reshape(1, -1, *trail)
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx
