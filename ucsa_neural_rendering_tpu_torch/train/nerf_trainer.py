"""Per-scene Semantic-NeRF fitting (counterpart of
ucsa_neural_rendering_tpu/train/nerf_trainer.py):
  * ray sampling: n_rays uniform random pixels of one image per step;
  * losses: MSE(rgb) + 0.04 · NLL(semantics, ignore -1, mean over ALL rays)
            + 0.1 · L1(depth / one_m_to_scene_uom, where gt != 0);
  * optimizer: Adam(lr 1e-2, betas (0.9, 0.99), eps 1e-15) with coupled
    weight decay 1e-6 on the MLPs and none on the hash table;
  * the occupancy grid's rotating-slab refresh, every occ_cfg.update_every
    steps by the caller;
  * the full-frame deterministic render.

The trainer owns the model and its optimizer and updates them in place (the
JAX package threads params and optimizer state through pure functions).
Randomness comes from the caller's torch.Generator where the JAX package
takes a key. Train-step table packing (`train_packed_max_entries`) is not
ported: the JAX package turns it on only on a TPU, so its step on any other
backend is the unpacked one, which this is.
"""

import torch

from ..data.rays import get_rays_sampled
from ..ops.occupancy import OccupancyConfig, init_grid, update_grid
from ..ops.renderer import (RenderConfig, normalize_semantics,
                            render_rays_staged, render_rays_train)
from ..utils.device import resolve_device


def make_nerf_optimizer(model, lr: float = 1e-2,
                        weight_decay: float = 1e-6) -> torch.optim.Adam:
    """Adam with the reference's two param groups: coupled weight decay (added
    to the gradient before the moments) on the MLPs, none on the hash
    table."""
    table = [p for n, p in model.named_parameters() if n.startswith("encoder.")]
    mlps = [p for n, p in model.named_parameters()
            if not n.startswith("encoder.")]
    return torch.optim.Adam([{"params": mlps, "weight_decay": weight_decay},
                             {"params": table, "weight_decay": 0.0}],
                            lr=lr, betas=(0.9, 0.99), eps=1e-15)


def nerf_losses(outputs: dict, gt_rgb: torch.Tensor, labels: torch.Tensor,
                gt_depth: torch.Tensor, one_m_to_scene_uom,
                num_classes: int):
    """The reference's 3-loss objective on one ray batch. labels use -1 as
    ignore, gt_depth 0 as invalid. Returns (total, dict of parts)."""
    loss_rgb = ((outputs["image"] - gt_rgb) ** 2).mean()

    sem, invalid = normalize_semantics(outputs["semantics"])
    labels = torch.where(invalid, -1, labels)
    logp = torch.log(sem + 1e-15)
    valid = labels >= 0
    picked = torch.gather(logp, -1,
                          labels.clamp(0, num_classes - 1)[..., None])[..., 0]
    # torch NLLLoss(reduction='none') gives 0 at ignored targets and the
    # reference then takes .mean() over ALL rays: keep that normalization
    loss_sem = torch.where(valid, -picked, torch.zeros_like(picked)).mean()

    depth_valid = gt_depth != 0
    l1 = (outputs["depth"] / one_m_to_scene_uom - gt_depth).abs()
    n_valid = depth_valid.sum().clamp_min(1)
    loss_depth = torch.where(depth_valid, l1,
                             torch.zeros_like(l1)).sum() / n_valid

    total = loss_rgb + 0.04 * loss_sem + 0.1 * loss_depth
    return total, {"loss_nerf_rgb": loss_rgb, "loss_nerf_semantics": loss_sem,
                   "loss_depth": loss_depth, "loss_nerf_total": total}


class NeRFTrainer:
    def __init__(self, model, render_cfg: RenderConfig | None = None,
                 lr: float = 1e-2, n_rays: int = 4096,
                 image_hw: tuple[int, int] = (240, 320), device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = render_cfg or RenderConfig()
        self.lr = lr
        self.n_rays = n_rays
        self.H, self.W = image_hw
        self.occ_cfg = OccupancyConfig()
        self.optimizer = None
        self._occ_slab = 0

    def init(self, params=None) -> torch.optim.Adam:
        """Load `params` (a SemanticNeRF state dict, e.g. from
        models.convert.params_from_jax) when given, and start a fresh Adam
        (moments at zero)."""
        if params is not None:
            self.model.load_state_dict(params)
        self.optimizer = make_nerf_optimizer(self.model, self.lr)
        return self.optimizer

    # --- occupancy state ---
    def init_occupancy(self) -> torch.Tensor:
        self._occ_slab = 0
        return init_grid(self.occ_cfg, self.device)

    @torch.no_grad()
    def update_occupancy(self, grid: torch.Tensor,
                         generator: torch.Generator | None = None,
                         jitter: torch.Tensor | None = None) -> torch.Tensor:
        """Refresh the density EMA grid (call every occ_cfg.update_every
        steps) on the next of occ_cfg.refresh_slabs rotating x-slabs, with
        the sampled-corner density probe. The probe jitter comes from
        `generator` unless given. Returns the new grid."""
        slab = self._occ_slab % self.occ_cfg.refresh_slabs
        self._occ_slab = slab + 1
        return update_grid(grid, self.model.density_probe, self.model.bound,
                           generator, self.occ_cfg, slab_index=slab,
                           jitter=jitter)

    def _draws(self, generator: torch.Generator) -> dict:
        """One step's random draws on the generator's device: pixel indices
        [n_rays] and the coarse / fine inverse-CDF uniforms."""
        n, dev = self.n_rays, generator.device
        return {
            "inds": torch.randint(0, self.H * self.W, (n,),
                                  generator=generator, device=dev),
            "u_coarse": torch.rand((n, self.cfg.num_steps),
                                   generator=generator, device=dev),
            "u_fine": torch.rand((n, self.cfg.upsample_steps),
                                 generator=generator, device=dev),
        }

    def train_step(self, batch: dict, generator: torch.Generator | None,
                   occ_grid: torch.Tensor, draws: dict | None = None) -> dict:
        """One image, one ray batch, one Adam step on the model in place.

        batch: pose [4,4], intrinsics [4], image [H,W,3], label [H,W] int
        (-1 ignore), depth [H,W] (0 invalid), one_m_to_scene_uom, as tensors
        on the trainer's device. draws (inds, u_coarse, u_fine, as _draws
        makes them) replaces the generator's draws, e.g. to replay the JAX
        package's. Returns the loss parts (0-d tensors, not synchronised);
        the parameters' .grad keep this step's gradient until the next.
        """
        if self.optimizer is None:
            self.init()
        if draws is None:
            draws = self._draws(generator)
        dev = self.device
        rays_o, rays_d, dnorms, inds = get_rays_sampled(
            batch["pose"], batch["intrinsics"], self.H, self.W,
            inds=draws["inds"], device=dev)
        gt_rgb = batch["image"].reshape(-1, 3)[inds]
        labels = batch["label"].reshape(-1)[inds]
        gt_depth = batch["depth"].reshape(-1)[inds]
        outputs = render_rays_train(
            self.model, rays_o, rays_d, dnorms,
            draws["u_coarse"].to(dev).contiguous(),
            draws["u_fine"].to(dev).contiguous(), self.cfg, occ_grid)
        total, parts = nerf_losses(outputs, gt_rgb, labels, gt_depth,
                                   batch["one_m_to_scene_uom"],
                                   self.model.num_semantic_classes)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in parts.items()}

    # --- full-frame render ---
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
