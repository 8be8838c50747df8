"""Build, binding and launch counters of the port's hand-written CUDA kernels.

Each kernel is one source under `csrc/` with a plain C entry point
`launch_<name>(..., stream)` that returns `cudaGetLastError()` after the
launch; sources may include the shared headers `csrc/*.cuh`. `build()`
compiles every source with its own `nvcc` process, all started together,
into `build/torch_kernels/` at the repository root
(`-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared`); the
libraries are loaded with ctypes. A library is reused while its source, the
headers and the flags are unchanged (the file name carries their hash).

Nothing here runs at import time: the CPU tests import every module, and
the CPU path never builds or loads a kernel.

`LAUNCHES[name]` counts the launches of each kernel; a wrapper adds one
where it launches, and `reset_launches()` sets every count to 0.

`plain_versions()` makes the render and training paths call the plain
versions on the card: the reference that `chip_smoke.py` and the CUDA tests
hold the kernel path to.
"""

import contextlib
import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no FMA contraction: the kernels round like the plain
              # PyTorch versions, which multiply and add as separate ops
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name → argument types of launch_<name> (the stream comes last)
SIGNATURES = {
    # table_bf16, x01, meta, out, n_points, n_levels, n_features
    "hash_encode_fwd": [_P, _P, _P, _P, _I, _I, _I],
    # rays_o, rays_d, grid, cand_t, u, z_out, n_rays, n_cand, n_samples,
    # grid_res, bound, min_near, proposal, floor, threshold, density_scale,
    # u_stride
    "occ_placement": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                      _F, _F, _F, _I],
    # z, sigma, u, new_z, z_sorted, order, n_rays, s1, s2, density_scale,
    # u_stride
    "importance_resample": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I],
    # z, sigma, rgb, sem, dnorm, image, sem_out, depth, n_rays, n_samples,
    # n_classes, density_scale, threshold
    "composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F],
    # x01, g, meta, grad, n_points, n_levels, n_features, stochastic
    "hash_encode_bwd": [_P, _P, _P, _P, _I, _I, _I, _I],
    # table_bf16, x01, meta, out, n_points, n_levels, n_features
    "hash_encode_sampled": [_P, _P, _P, _P, _I, _I, _I],
    # z, sigma, rgb, dnorm, g_image, g_sem, g_depth, d_sigma, d_rgb, d_sem,
    # n_rays, n_samples, n_classes, density_scale, threshold
    "composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _F, _F],
    # grid, sigma, out, n_cells, offset, n_slab, decay
    "occ_grid_update": [_P, _P, _P, _I, _I, _I, _F],
    # x, ldx, w0, w1, w2, y, n, n_blocks, n_layers, d0, d1, d2, d3
    "mlp_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    # x, ldx, dy, w0, w1, w2, dx, partial, dw, n, n_blocks, n_layers, d0,
    # d1, d2, d3
    "mlp_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                _I],
    # table, idx, out, m, row_bytes
    "dma_gather": [_P, _P, _P, _I, _I],
}

LAUNCHES = {name: 0 for name in SIGNATURES}
BUILD_LOG = {}
_LIBS = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# where the render and training paths call each wrapper: (calling module,
# wrapper, module of the wrapper and of its plain version `<wrapper>_plain`).
# dma_gather has no site here: only its own benchmark calls it.
_CALL_SITES = (
    ("models.hash_encoding", "hash_encode", "models.hash_encoding"),
    ("models.hash_encoding", "hash_encode_bwd", "models.hash_encoding"),
    ("models.hash_encoding", "hash_encode_sampled", "models.hash_encoding"),
    ("models.semantic_nerf", "mlp_fwd", "models.semantic_nerf"),
    ("models.semantic_nerf", "mlp_bwd", "models.semantic_nerf"),
    ("ops.renderer", "occ_placement", "ops.placement"),
    ("ops.renderer", "importance_resample", "ops.placement"),
    ("ops.compositing", "composite_fwd", "ops.compositing"),
    ("ops.compositing", "composite_bwd", "ops.compositing"),
    ("ops.occupancy", "occ_grid_update", "ops.occupancy"),
)


@contextlib.contextmanager
def plain_versions(*names):
    """Within this block the render and training paths call each kernel's
    plain version in place of its wrapper, whatever the device; with
    `names`, only those wrappers' (e.g. "mlp_fwd", "mlp_bwd"). The wrappers
    themselves do not change (given a CUDA tensor, one still launches its
    kernel), so a render or a training step in this block (its backward
    included) counts no launches of the kernels swapped."""
    unknown = set(names) - {name for _, name, _ in _CALL_SITES}
    if unknown:
        raise ValueError(f"no call site for {sorted(unknown)}")
    pkg = __name__.rpartition(".")[0]
    saved = []
    try:
        for site, name, home in _CALL_SITES:
            if names and name not in names:
                continue
            mod = importlib.import_module(f"{pkg}.{site}")
            plain = getattr(importlib.import_module(f"{pkg}.{home}"),
                            f"{name}_plain")
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> float:
    """Compile the kernels' libraries that are missing, one nvcc process per
    source, all at once. Returns the seconds it took; raises with the
    compiler's output if any build fails. The ptxas report of each build
    (registers, shared memory, spills) lands in BUILD_LOG[name]."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _fn(name: str):
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"launch_{name}")
        fn.argtypes = SIGNATURES[name] + [_P]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return _LIBS[name]


@functools.cache
def sm_count(device: torch.device) -> int:
    """The number of streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(t: torch.Tensor, what: str, dtype, shape=None, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape
    (and on `device` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != torch.device(device):
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def launch(name: str, *args):
    """Launch kernel `name` on the current stream with `args` (tensors pass
    their data pointer), raise if the launch failed, and count it."""
    fn = _fn(name)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
