"""Per-scene Semantic-NeRF fitting (counterpart of
ucsa_neural_rendering_tpu/train/nerf_trainer.py):
  * ray sampling: n_rays uniform random pixels of one image per step;
  * losses: MSE(rgb) + 0.04 · NLL(semantics, ignore -1, mean over ALL rays)
            + 0.1 · L1(depth / one_m_to_scene_uom, where gt != 0);
  * optimizer: Adam(lr 1e-2, betas (0.9, 0.99), eps 1e-15) with coupled
    weight decay 1e-6 on the MLPs and none on the hash table;
  * the occupancy grid's rotating-slab refresh, every occ_cfg.update_every
    steps by the caller, through the sampled-corner probe or, with
    occ_cfg.probe_sampled False, the exact density;
  * the full-frame deterministic render.

Without an occupancy grid (occ_grid None: the reference's dense program)
the steps and renders place their coarse samples stratified.

The trainer owns the model and its optimizer and updates them in place (the
JAX package threads params and optimizer state through pure functions).
Randomness comes from the caller's torch.Generator where the JAX package
takes a key. Where ops.renderer.packing_enabled says (on the card), a step
repacks the table's coarse levels as bf16 cell rows
(`train_packed_max_entries`) and encodes through them, and the renders go
through the packed table of the current table version (`packed_max_entries`,
`packed_dtype`; one pack per version, PackedTableCache).

Data parallelism (`mesh=`, a parallel.Mesh; JAX `nerf_trainer.py:89-116`):
every rank draws the whole step's randomness from its generator (the same
seed on every rank) and renders its block of the rays; each loss is the
rank's share of the global mean (nerf_losses), the gradients (the dense
table's too) are summed over the ranks before the one Adam step every rank
applies, so the parameters stay equal; the occupancy refresh runs on rank
0 and is broadcast; the full-frame renders shard their chunks.
"""

import torch

from ..data.rays import get_rays_sampled
from ..models.packed_table import PackedTableCache
from ..ops.occupancy import (OccupancyConfig, init_grid, probe_jitter,
                             update_grid)
from ..ops.renderer import (RenderConfig, normalize_semantics,
                            packing_enabled, render_rays_staged,
                            render_rays_train)
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
                num_classes: int, mesh=None):
    """The reference's 3-loss objective on one ray batch. labels use -1 as
    ignore, gt_depth 0 as invalid. Returns (total, dict of parts).

    Under a mesh the rays are this rank's block of the step's batch (or
    all of it, on every rank, where the batch runs replicated: blocks are
    equal either way) and each part is this rank's share of the global
    one, so that the parts and their gradients sum over the ranks to the
    batch's: the means divided by the world size, the depth sum divided by
    the valid rays summed over the ranks."""
    w = 1 if mesh is None else mesh.size
    loss_rgb = ((outputs["image"] - gt_rgb) ** 2).mean()
    if w > 1:
        loss_rgb = loss_rgb / w

    sem, invalid = normalize_semantics(outputs["semantics"])
    labels = torch.where(invalid, -1, labels)
    logp = torch.log(sem + 1e-15)
    valid = labels >= 0
    picked = torch.gather(logp, -1,
                          labels.clamp(0, num_classes - 1)[..., None])[..., 0]
    # torch NLLLoss(reduction='none') gives 0 at ignored targets and the
    # reference then takes .mean() over ALL rays: keep that normalization
    loss_sem = torch.where(valid, -picked, torch.zeros_like(picked)).mean()
    if w > 1:
        loss_sem = loss_sem / w

    depth_valid = gt_depth != 0
    l1 = (outputs["depth"] / one_m_to_scene_uom - gt_depth).abs()
    n_valid = depth_valid.sum()
    if mesh is not None:
        n_valid = mesh.all_reduce_(n_valid)
    n_valid = n_valid.clamp_min(1)
    loss_depth = torch.where(depth_valid, l1,
                             torch.zeros_like(l1)).sum() / n_valid

    total = loss_rgb + 0.04 * loss_sem + 0.1 * loss_depth
    return total, {"loss_nerf_rgb": loss_rgb, "loss_nerf_semantics": loss_sem,
                   "loss_depth": loss_depth, "loss_nerf_total": total}


class NeRFTrainer:
    def __init__(self, model, render_cfg: RenderConfig | None = None,
                 lr: float = 1e-2, n_rays: int = 4096,
                 image_hw: tuple[int, int] = (240, 320), device="cuda",
                 mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = render_cfg or RenderConfig()
        self.lr = lr
        self.n_rays = n_rays
        self.H, self.W = image_hw
        self.occ_cfg = OccupancyConfig()
        self.optimizer = None
        self._occ_slab = 0
        self._packed_cache = PackedTableCache(self.model)

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
        the sampled-corner density probe or, when occ_cfg.probe_sampled is
        False, the exact density. The probe jitter comes from `generator`
        unless given. Returns the new grid."""
        slab = self._occ_slab % self.occ_cfg.refresh_slabs
        self._occ_slab = slab + 1
        if self.occ_cfg.probe_sampled:
            density_fn = self.model.density_probe
        else:
            density_fn = lambda x: self.model.density(x)[0]
        if self.mesh is None:
            return update_grid(grid, density_fn, self.model.bound, generator,
                               self.occ_cfg, slab_index=slab, jitter=jitter)
        # every rank draws the jitter (its generator stays in step with
        # rank 0's); rank 0 refreshes and broadcasts the grid
        if jitter is None:
            jitter = probe_jitter(generator, self.occ_cfg, slab)
        if self.mesh.rank == 0:
            grid = update_grid(grid, density_fn, self.model.bound, generator,
                               self.occ_cfg, slab_index=slab, jitter=jitter)
        else:
            grid = torch.empty_like(grid)
        return self.mesh.broadcast_(grid)

    def draw(self, generator: torch.Generator, images: int = 1) -> dict:
        """The random draws of a step on `images` images, on the
        generator's device: pixel indices [images·n_rays] (image k's at
        [k·n_rays, (k+1)·n_rays)), then the coarse uniforms (inverse-CDF
        positions, or without a grid the stratified jitter) and the fine
        inverse-CDF uniforms of all those rays."""
        n, dev = images * self.n_rays, generator.device
        return {
            "inds": torch.randint(0, self.H * self.W, (n,),
                                  generator=generator, device=dev),
            "u_coarse": torch.rand((n, self.cfg.num_steps),
                                   generator=generator, device=dev),
            "u_fine": torch.rand((n, self.cfg.upsample_steps),
                                 generator=generator, device=dev),
        }

    def sample_rays(self, batch: dict, inds: torch.Tensor) -> dict:
        """The rays through pixels `inds` of one image (batch as train_step
        takes it) and their targets: rays_o, rays_d, direction_norms,
        rgb, label, depth."""
        rays_o, rays_d, dnorms, inds = get_rays_sampled(
            batch["pose"], batch["intrinsics"], self.H, self.W, inds=inds,
            device=self.device)
        return {"rays_o": rays_o, "rays_d": rays_d,
                "direction_norms": dnorms,
                "rgb": batch["image"].reshape(-1, 3)[inds],
                "label": batch["label"].reshape(-1)[inds],
                "depth": batch["depth"].reshape(-1)[inds]}

    def packed_for(self, cfg: RenderConfig | None = None):
        """The render's packed table of the model's current table under cfg
        (the trainer's by default), packed once per table version
        (PackedTableCache), or None where packing is off on this device
        (packing_enabled), at a budget ≤ 0 or where no level fits."""
        if not packing_enabled(self.device):
            return None
        return self._packed_cache(cfg or self.cfg)

    def train_packed(self):
        """A training step's packed table: the coarse levels within
        train_packed_max_entries as bf16 rows of the current table, packed
        anew (no gradient reaches it), or None where train packing is off
        or no level fits, and under stochastic_fwd True, whose encode reads
        no packed table (HashGridEncoding.forward)."""
        budget = self.cfg.train_packed_max_entries
        if budget <= 0 or self.model.stochastic_fwd is True \
                or not packing_enabled(self.device, train=True):
            return None
        packed = self.model.pack_table(budget)
        return packed if packed.n_packed else None

    def step_on_rays(self, rays: dict, u_coarse: torch.Tensor,
                     u_fine: torch.Tensor, occ_grid: torch.Tensor | None,
                     one_m_to_scene_uom) -> dict:
        """One Adam step on the model in place from a ray batch (as
        sample_rays gives it, or several concatenated): the training render
        at the uniforms u_coarse, u_fine through the step's packed table
        (train_packed), the losses (one_m_to_scene_uom a number or one per
        ray), backward, step. Under a mesh each rank renders its block of
        the rays and the gradients are summed over the ranks before the
        step. Returns the loss parts (the batch's, on every rank)."""
        if self.optimizer is None:
            self.init()
        dev = self.device
        outputs = render_rays_train(
            self.model, rays["rays_o"], rays["rays_d"],
            rays["direction_norms"], u_coarse.to(dev).contiguous(),
            u_fine.to(dev).contiguous(), self.cfg, occ_grid,
            self.train_packed(), self.mesh)
        n = rays["rays_o"].shape[0]
        sl = None if self.mesh is None else self.mesh.block(n)
        cut = (lambda t: t) if sl is None else (
            lambda t: t[sl] if torch.is_tensor(t) and t.ndim
            and t.shape[0] == n else t)
        total, parts = nerf_losses(outputs, cut(rays["rgb"]),
                                   cut(rays["label"]), cut(rays["depth"]),
                                   cut(one_m_to_scene_uom),
                                   self.model.num_semantic_classes,
                                   self.mesh)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        parts = {k: v.detach() for k, v in parts.items()}
        if self.mesh is not None:
            self.mesh.all_reduce_grads(self.model.parameters())
            summed = self.mesh.all_reduce_(torch.stack(list(parts.values())))
            parts = dict(zip(parts, summed))
        self.optimizer.step()
        return parts

    def train_step(self, batch: dict, generator: torch.Generator | None,
                   occ_grid: torch.Tensor | None,
                   draws: dict | None = None) -> dict:
        """One image, one ray batch, one Adam step on the model in place.

        batch: pose [4,4], intrinsics [4], image [H,W,3], label [H,W] int
        (-1 ignore), depth [H,W] (0 invalid), one_m_to_scene_uom, as tensors
        on the trainer's device; occ_grid None: the dense program. draws
        (inds, u_coarse, u_fine, as draw makes them) replaces the
        generator's draws, e.g. to replay the JAX package's. Returns the
        loss parts (0-d tensors, not synchronised); the parameters' .grad
        keep this step's gradient until the next.
        """
        if draws is None:
            draws = self.draw(generator)
        return self.step_on_rays(self.sample_rays(batch, draws["inds"]),
                                 draws["u_coarse"], draws["u_fine"],
                                 occ_grid, batch["one_m_to_scene_uom"])

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
        the JAX package's signature; the rays carry the camera. The density
        calls go through packed_for()'s table.
        """
        if params is not None:
            self.model.load_state_dict(params)
        out = render_rays_staged(self.model, rays["rays_o"], rays["rays_d"],
                                 rays["direction_norms"], self.cfg, occ_grid,
                                 self.packed_for(), self.mesh)
        sem, invalid = normalize_semantics(out["semantics"])
        H, W = self.H, self.W
        return {
            "nerf_rgb": out["image"].reshape(H, W, 3),
            "nerf_semantics": sem.argmax(dim=-1).reshape(H, W),
            "nerf_semantics_raw": sem.reshape(H, W, -1),
            "nerf_depth": out["depth"].reshape(H, W),
            "nerf_invalid": invalid.reshape(H, W),
        }
