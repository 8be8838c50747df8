"""Camera geometry: NGP pose convention + pinhole ray generation
(counterpart of ucsa_neural_rendering_tpu/data/rays.py)."""

import numpy as np
import torch

from ..utils.device import resolve_device


def nerf_matrix_to_ngp(pose: np.ndarray) -> np.ndarray:
    """NeRF/OpenGL c2w → instant-ngp axis convention: cyclic (x,y,z)→(y,z,x)
    row permutation with y/z column negation."""
    pose = np.asarray(pose)
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _pixel_dirs(i, j, intrinsics):
    """Pixel centers → camera-space unit directions [N,3] and norms [N]."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(i)], dim=-1)
    norms = torch.linalg.norm(dirs, dim=-1)
    return dirs / norms[..., None], norms


def get_rays(pose, intrinsics, H: int, W: int, device="cuda"):
    """Full-image rays for one c2w pose [4,4] and intrinsics (fx,fy,cx,cy).

    Returns dict rays_o [H*W,3], rays_d [H*W,3], direction_norms [H*W] in
    row-major pixel order, float32 on `device`.
    """
    device = resolve_device(device)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                 device=device)
    jj, ii = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    i = ii.reshape(-1) + 0.5
    j = jj.reshape(-1) + 0.5
    dirs, norms = _pixel_dirs(i, j, intrinsics)
    # the camera rotation as an explicit f32 multiply-and-sum: geometry must
    # not go through a reduced-precision (TF32/bf16) matmul path
    rays_d = (dirs[:, None, :] * pose[None, :3, :3]).sum(-1)
    rays_o = pose[:3, 3].expand_as(rays_d).contiguous()
    return {"rays_o": rays_o, "rays_d": rays_d, "direction_norms": norms}
