"""ctypes bindings for the port's native image loader (counterpart of the
JAX package's data/native_loader.py and of the repository's native/): the
port's own copy of ucsa_loader.cpp (`native/ucsa_loader.cpp` in this
package) decodes JPEG and PNG with libjpeg and libpng, resizes by area
(RGB, to f32 in [0, 1]) or nearest (labels, depth), and fills whole
batches on a C++ thread pool, outside the GIL.

Build: at first use, one `g++ -O3 -march=native -shared -fPIC` of that
source (the compiler is $CXX where set) into `build/torch_native/` at the
repository root, rebuilt when the source is newer than the library.
Nothing else is written, and the repository's native/build.py and
native/libucsa_loader.so are never used. The build takes the first route
that the machine allows:
  a  the system's headers and `-ljpeg -lpng`;
  b  the runtime libraries alone (a machine without the development
     packages): the headers this package carries (native/include, libjpeg
     ABI 6.2 and libpng 1.6, with their licences) and the libraries linked
     by file name, with their directory as the rpath. Only a library whose
     file name carries the ABI those headers declare is taken (libjpeg*.so.62*,
     libpng16*.so.16*), from `ldconfig -p` or beside a Python package
     (pillow.libs, opencv_python*.libs and the like in site-packages).
`ROUTE` says which one built the library.

UCSA_NATIVE_LOADER:
  unset  the library when it builds and loads; otherwise the reason
         (the missing header or library, or the compiler's first error)
         is printed once and the datasets read through data/image_io.py;
  0      off (image_io), as in the JAX package;
  1      required: a library that cannot be built or loaded raises with
         the reason at first use.
`status()` gives the state and the reason; the JAX package's silent
fallback has no counterpart here.
"""

import ctypes
import glob
import os
import re
import site
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "ucsa_loader.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
LIB = BUILD_DIR / "libucsa_loader.so"
INCLUDE = _PKG / "native" / "include"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
LINK_FLAGS = ["-ljpeg", "-lpng", "-lpthread"]
# the runtime libraries route b links: stem → the macro in the carried
# headers that declares their ABI
_ABI = {"libjpeg": ("jconfig.h", "JPEG_LIB_VERSION"),
        "libpng16": ("png.h", "PNG_LIBPNG_VER_SONUM")}

ROUTE = None
_lib = None
_tried = False
_reason = None


class NativeLoaderError(RuntimeError):
    pass


def _first_error(stderr: str) -> str:
    """The compiler's reason in a few words: the missing header or
    library where that is what failed, else its first error line."""
    m = re.search(r"fatal error: ([^:\s]+): No such file", stderr)
    if m:
        return f"header {m.group(1)} not found"
    m = re.search(r"cannot find (-l[^\s:]+)", stderr)
    if m:
        return f"library {m.group(1)} not found"
    lines = [ln for ln in stderr.splitlines() if "error" in ln]
    return (lines or stderr.strip().splitlines() or ["no output"])[0]


def _header_abi(stem: str) -> str:
    header, macro = _ABI[stem]
    m = re.search(rf"#\s*define\s+{macro}\s+(\d+)",
                  (INCLUDE / header).read_text())
    return m.group(1)


def _library_dirs() -> list:
    """Where route b looks for the runtime libraries: ldconfig's cache,
    then the directories of libraries bundled beside Python packages."""
    dirs = []
    try:
        cache = subprocess.run(["ldconfig", "-p"], capture_output=True,
                               text=True, timeout=60).stdout
        dirs += [os.path.dirname(ln.split(" => ")[-1].strip())
                 for ln in cache.splitlines() if " => " in ln]
    except OSError:
        pass
    roots = set(site.getsitepackages()) | {
        sysconfig.get_paths()[k] for k in ("purelib", "platlib")}
    for root in sorted(roots):
        dirs += sorted(glob.glob(os.path.join(root, "*.libs")))
    return list(dict.fromkeys(dirs))


def runtime_libraries() -> dict:
    """Route b's libraries: stem → the first file, in _library_dirs'
    order, named `<stem>.so.<abi>*` or `<stem>-<hash>.so.<abi>*` with the
    carried headers' ABI; None where there is none."""
    found = {}
    dirs = _library_dirs()
    for stem in _ABI:
        abi = _header_abi(stem)
        hits = [f for d in dirs for pat in (f"{stem}.so.{abi}*",
                                            f"{stem}-*.so.{abi}*")
                for f in sorted(glob.glob(os.path.join(d, pat)))]
        found[stem] = hits[0] if hits else None
    return found


def _commands(out: str):
    """(route, compiler argv) for each route, in order."""
    cxx = os.environ.get("CXX", "g++")
    yield "a", [cxx, *CXX_FLAGS, str(SRC), "-o", out, *LINK_FLAGS]
    libs = runtime_libraries()
    missing = [stem for stem, f in libs.items() if f is None]
    if missing:
        yield "b", f"no runtime {' or '.join(missing)} of the carried " \
                   f"headers' ABI found"
        return
    rpath = [f"-Wl,-rpath,{d}" for d in
             dict.fromkeys(os.path.dirname(f) for f in libs.values())]
    yield "b", [cxx, *CXX_FLAGS, f"-I{INCLUDE}", str(SRC), "-o", out,
                *libs.values(), *rpath, "-lpthread"]


def build(force: bool = False) -> Path:
    """Compile SRC into LIB unless LIB is newer than SRC (or force), by
    the first route that builds (module docstring). Returns LIB; raises
    NativeLoaderError with every route's reason."""
    global ROUTE
    if not force and LIB.is_file() and \
            LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: parallel builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".libucsa_loader.",
                               suffix=".so")
    os.close(fd)
    reasons = []
    try:
        for route, cmd in _commands(tmp):
            if isinstance(cmd, str):
                reasons.append(f"route {route}: {cmd}")
                continue
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError:
                raise NativeLoaderError(
                    f"compiler {cmd[0]!r} not found") from None
            if proc.returncode == 0:
                os.chmod(tmp, 0o755)
                os.replace(tmp, LIB)
                ROUTE = route
                return LIB
            reasons.append(f"route {route}: {cmd[0]} failed: "
                           f"{_first_error(proc.stderr)}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise NativeLoaderError("; ".join(reasons))


def _bind(lib):
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    for name, out in (("ucsa_load_rgb", f32), ("ucsa_load_label", i32),
                      ("ucsa_load_depth", f32)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, out]
        fn.restype = ctypes.c_int
    lib.ucsa_load_rgb_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, f32, i32]
    lib.ucsa_load_rgb_batch.restype = None
    return lib


def _mode():
    return os.environ.get("UCSA_NATIVE_LOADER")


def _load():
    global _lib, _tried, _reason
    if _tried:
        if _lib is None and _mode() == "1":
            raise NativeLoaderError(
                f"UCSA_NATIVE_LOADER=1 but the native loader is "
                f"unavailable: {_reason}")
        return _lib
    _tried = True
    if _mode() == "0":
        _reason = "off (UCSA_NATIVE_LOADER=0)"
        return None
    try:
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except OSError:
            # a library built on another machine (a copied tree) may not
            # load here, though it is newer than its source: build anew
            _lib = _bind(ctypes.CDLL(str(build(force=True))))
    except (NativeLoaderError, OSError) as e:
        _reason = str(e)
        if _mode() == "1":
            raise NativeLoaderError(
                f"UCSA_NATIVE_LOADER=1 but the native loader is "
                f"unavailable: {_reason}") from None
        print(f"[native_loader] unavailable ({_reason}); reading images "
              f"through data/image_io.py", flush=True)
    return _lib


def reset():
    """Forget the loaded library and its state, so that the next call
    builds or loads anew (after a change of UCSA_NATIVE_LOADER or CXX)."""
    global _lib, _tried, _reason
    _lib, _tried, _reason = None, False, None


def available() -> bool:
    return _load() is not None


def status() -> dict:
    """{"available", "reason" (None when available), "library",
    "mode" (UCSA_NATIVE_LOADER), "route" (the route that built the
    library in this process; None where an earlier build was reused)};
    loads the library (or fails to) first. With UCSA_NATIVE_LOADER=1 an
    unavailable library raises here too."""
    ok = available()
    return {"available": ok, "reason": None if ok else _reason,
            "library": str(LIB), "mode": _mode(), "route": ROUTE}


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_rgb(path: str, w: int, h: int) -> np.ndarray | None:
    """[h, w, 3] float32 in [0, 1] (area resize), or None when the
    library is unavailable or the file does not decode."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w, 3), np.float32)
    rc = lib.ucsa_load_rgb(str(path).encode(), w, h,
                           _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def load_label(path: str, w: int, h: int) -> np.ndarray | None:
    """[h, w] int32 raw stored values of a one-channel 8- or 16-bit PNG
    (nearest resize), or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w), np.int32)
    rc = lib.ucsa_load_label(str(path).encode(), w, h,
                             _ptr(out, ctypes.c_int32))
    return out if rc == 0 else None


def load_depth(path: str, w: int, h: int) -> np.ndarray | None:
    """[h, w] float32 meters from a 16-bit millimetre PNG (nearest
    resize), or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w), np.float32)
    rc = lib.ucsa_load_depth(str(path).encode(), w, h,
                             _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def load_rgb_batch(paths: list[str], w: int, h: int):
    """([n, h, w, 3] float32, status [n] int32: 0 where a file decoded)
    through the C++ thread pool, or (None, None) when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None, None
    n = len(paths)
    out = np.empty((n, h, w, 3), np.float32)
    status_ = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.ucsa_load_rgb_batch(arr, n, w, h, _ptr(out, ctypes.c_float),
                            _ptr(status_, ctypes.c_int32))
    return out, status_
