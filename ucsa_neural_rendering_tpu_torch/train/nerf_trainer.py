"""Per-scene Semantic-NeRF trainer (counterpart of
ucsa_neural_rendering_tpu/train/nerf_trainer.py). This slice ports the
full-frame deterministic render (`render_image`) and the occupancy state it
reads; `train_step`, `update_occupancy` and the optimizer come with the
training slice."""

import torch

from ..ops.occupancy import OccupancyConfig, init_grid
from ..ops.renderer import (RenderConfig, normalize_semantics,
                            render_rays_staged)
from ..utils.device import resolve_device


class NeRFTrainer:
    def __init__(self, model, render_cfg: RenderConfig | None = None,
                 image_hw: tuple[int, int] = (240, 320), device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = render_cfg or RenderConfig()
        self.H, self.W = image_hw
        self.occ_cfg = OccupancyConfig()

    # --- occupancy state ---
    def init_occupancy(self) -> torch.Tensor:
        return init_grid(self.occ_cfg, self.device)

    # --- public API ---
    @torch.no_grad()
    def render_image(self, params, pose, intrinsics, rays: dict,
                     occ_grid: torch.Tensor | None = None) -> dict:
        """Full-frame deterministic render → nerf_rgb [H,W,3], nerf_semantics
        (argmax) [H,W], nerf_semantics_raw (normalized probs) [H,W,C],
        nerf_depth [H,W], nerf_invalid [H,W].

        params: a SemanticNeRF state dict to render with (loaded into the
        model, e.g. from models.convert.params_from_jax), or None for the
        model's current parameters. pose and intrinsics are accepted for
        the JAX package's signature; the rays carry the camera.
        """
        if params is not None:
            self.model.load_state_dict(params)
        out = render_rays_staged(self.model, rays["rays_o"], rays["rays_d"],
                                 rays["direction_norms"], self.cfg, occ_grid)
        sem, invalid = normalize_semantics(out["semantics"])
        H, W = self.H, self.W
        return {
            "nerf_rgb": out["image"].reshape(H, W, 3),
            "nerf_semantics": sem.argmax(dim=-1).reshape(H, W),
            "nerf_semantics_raw": sem.reshape(H, W, -1),
            "nerf_depth": out["depth"].reshape(H, W),
            "nerf_invalid": invalid.reshape(H, W),
        }
