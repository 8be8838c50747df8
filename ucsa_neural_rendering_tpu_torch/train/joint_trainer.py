"""Joint NeRF + segmentation training, the continual-adaptation core
(counterpart of ucsa_neural_rendering_tpu/train/joint_trainer.py, the
reference's JointTrainLightningNet):
  * phase 1, `nerf_fit_step` / `nerf_fit_epoch`: the seg net's eval-mode
    pseudo-labels supervise the Semantic-NeRF, one Adam step per image
    (n_rays random rays each), the occupancy refresh every
    nerf.occ_cfg.update_every steps;
  * phase 2, `joint_step`: render the new batch at the test budget; unless
    fix_nerf, the seg net's BN-trick pseudo-labels (BN stats updated when
    the batch holds more than one image) and the per-image (or fused) NeRF
    updates; then augment the renders and take one seg step on rendered ⊕
    old-scene replay ⊕ 25k replay;
  * `predict_frame`: a render at the predict budget and the seg net's
    labels of the given image, or of the render itself for a novel
    viewpoint.

JointTrainer owns a NeRFTrainer (`.nerf`) and a SegTrainer (`.seg`) and
updates them in place, as those do (the JAX package threads both states
through pure functions). Randomness comes from the caller's
torch.Generator; the methods that draw take `draws=` to replay the JAX
package's instead. The JAX package's `fused_joint_step` (one XLA program
in place of five dispatches over the same math) is accepted and has one
eager path here. `nerf.use_occupancy: false` runs the reference's dense
program: no grid (init_occupancy and update_occupancy give None), and the
test and predict renders at the train config. `model.compute_dtype`
builds the default seg net with that compute dtype. Where
ops.renderer.packing_enabled says (on the card), the test and predict
renders go through the NeRF trainer's packed table of the current table
version and every NeRF step through its own bf16 repack (NeRFTrainer).

Data parallelism (`mesh=`, a parallel.Mesh; JAX `joint_trainer.py:50-58,
236-245`): both models stay replicated; the NeRF ray batches, the
full-frame render chunks, the BN trick's batch and the assembled seg batch
shard over the ranks where the world size divides them, and run whole on
every rank where it does not (assembled seg batches vary in size; their
gradients are summed all the same, so the ranks stay equal). Every rank
passes the same batches and a generator seeded alike.
"""

from dataclasses import replace

import torch

from ..data.augmentation import augment, draw_augment_params
from ..data.rays import get_rays
from ..models.deeplabv3 import DeepLabV3, seg_compute_dtype
from ..models.semantic_nerf import SemanticNeRF
from ..ops.renderer import (RenderConfig, normalize_semantics,
                            render_rays_staged)
from ..utils.device import resolve_device
from .nerf_trainer import NeRFTrainer
from .seg_trainer import SegTrainer


def _mean_parts(parts: list) -> dict:
    """The mean over steps (or images) of each loss part."""
    return {k: torch.stack([p[k] for p in parts]).mean() for k in parts[0]}


class JointTrainer:
    def __init__(self, exp: dict, image_hw=(240, 320), num_classes=40,
                 render_cfg: RenderConfig | None = None, n_rays=4096,
                 nerf_model: SemanticNeRF | None = None,
                 seg_model: DeepLabV3 | None = None,
                 test_render_cfg: RenderConfig | None = None,
                 predict_render_cfg: RenderConfig | None = None,
                 mesh=None, device="cuda"):
        """exp: the experiment config (optimizer.lr_seg, lr_nerf, name;
        nerf.use_occupancy, fused_image_step, fused_joint_step; fix_nerf;
        parity.double_softmax; model.compute_dtype). nerf_model, seg_model:
        built on `device` when not given (the JAX package's defaults:
        SemanticNeRF(bound 4), DeepLabV3-R101). mesh: a parallel.Mesh
        (its device replaces `device`), or None for one rank."""
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        nerf_exp = exp.get("nerf", {})
        # occupancy-guided sampling; false: the reference's dense program
        self.use_occupancy = nerf_exp.get("use_occupancy", True)
        self.H, self.W = image_hw
        self.num_classes = num_classes
        self.fix_nerf = exp.get("fix_nerf", False)
        self.cfg = render_cfg or RenderConfig()

        # the full-frame configs, as the JAX package derives them under
        # occupancy sampling: a proposal-placed train budget (e.g. 24 + 8)
        # renders from its symmetric total (32 + 32); test = early stop at
        # half the coarse budget (at most 16), the top 1/4 refined; predict
        # = half of test's stage 1 and budget, the top 1/8 refined. The
        # dense program renders both at the train config.
        if test_render_cfg is not None:
            self.test_cfg = test_render_cfg
        elif not self.use_occupancy:
            self.test_cfg = self.cfg
        else:
            base = self.cfg
            if base.proposal_placement:
                total = base.num_steps + base.upsample_steps
                base = replace(base, num_steps=total, upsample_steps=total)
            self.test_cfg = replace(
                base, early_stop=True,
                stage1_steps=max(1, min(16, base.num_steps // 2)),
                refine_fraction=0.25, proposal_placement=False)
        if predict_render_cfg is not None:
            self.predict_cfg = predict_render_cfg
        elif test_render_cfg is None and self.use_occupancy:
            self.predict_cfg = replace(
                self.test_cfg, early_stop=True,
                stage1_steps=max(1, self.test_cfg.stage1_steps // 2),
                num_steps=max(1, self.test_cfg.num_steps // 2),
                upsample_steps=max(1, self.test_cfg.upsample_steps // 2),
                refine_fraction=0.125)
        else:
            self.predict_cfg = self.test_cfg

        if nerf_model is None:
            nerf_model = SemanticNeRF(bound=4.0,
                                      num_semantic_classes=num_classes,
                                      device=self.device)
        if seg_model is None:
            seg_model = DeepLabV3(
                num_classes=num_classes, device=self.device,
                compute_dtype=seg_compute_dtype(exp.get("model")))
        opt = exp["optimizer"]
        self.lr_seg = float(opt["lr_seg"])
        self.nerf = NeRFTrainer(nerf_model, self.cfg,
                                lr=float(opt.get("lr_nerf", 1e-2)),
                                n_rays=n_rays, image_hw=image_hw,
                                device=self.device, mesh=mesh)
        self.seg = SegTrainer(seg_model, opt, lr_key="lr_seg",
                              double_softmax=bool(exp.get("parity", {}).get(
                                  "double_softmax", False)),
                              device=self.device, mesh=mesh)
        # one Adam step on the B·n_rays rays of a batch's B images in place
        # of B per-image steps (the JAX package's opt-in throughput mode)
        self.fuse_images = bool(nerf_exp.get("fused_image_step", False))

    def budget_summary(self) -> str:
        """One line of the active render budgets, as the JAX package logs
        it at a stage's start."""

        def one(cfg):
            s = f"{cfg.num_steps}+{cfg.upsample_steps}"
            if cfg.early_stop:
                s = f"es{cfg.stage1_steps}->{s} k{cfg.refine_fraction:g}"
            return s

        return (f"train={one(self.cfg)} test={one(self.test_cfg)} "
                f"predict={one(self.predict_cfg)} "
                f"occupancy={self.use_occupancy} "
                f"packed_dtype={self.test_cfg.packed_dtype}")

    def init(self, nerf_params=None, seg_state=None):
        """Load the NeRF's and the seg net's state dicts where given (e.g.
        from models.convert) and start both optimizers afresh."""
        self.nerf.init(nerf_params)
        self.seg.init(seg_state)

    def state_dict(self) -> dict:
        """What a resume needs of both trainers (after init): the two
        models' and the two optimizers' state dicts, and the refresh's slab
        counter. The tensors are the live ones, not copies."""
        return {"nerf": self.nerf.model.state_dict(),
                "nerf_opt": self.nerf.optimizer.state_dict(),
                "seg": self.seg.model.state_dict(),
                "seg_opt": self.seg.optimizer.state_dict(),
                "occ_slab": self.nerf._occ_slab}

    def load_state_dict(self, state: dict):
        """Restore a state_dict() into the initialised trainers. Optimizer
        step counts go back to the CPU, where the optimizers keep them
        unless fused or capturable (a checkpoint loaded onto the card
        would put them there)."""
        self.nerf.model.load_state_dict(state["nerf"])
        self.seg.model.load_state_dict(state["seg"])
        for opt, key in ((self.nerf.optimizer, "nerf_opt"),
                         (self.seg.optimizer, "seg_opt")):
            opt_state = state[key]
            if not any(g.get("fused") or g.get("capturable")
                       for g in opt_state["param_groups"]):
                opt_state = {**opt_state, "state": {
                    i: {k: v.cpu() if k == "step" else v
                        for k, v in s.items()}
                    for i, s in opt_state["state"].items()}}
            opt.load_state_dict(opt_state)
        self.nerf._occ_slab = int(state["occ_slab"])

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- seg
    def seg_infer(self, images, update_bn: bool = False):
        """The seg forward with dropout off; update_bn: the BN trick (BN
        batch stats, running stats updated). Returns (argmax labels [B, H,
        W], softmax probs [B, C, H, W])."""
        return self.seg.infer(self._t(images), update_bn=update_bn)

    def seg_pseudo_labels(self, images, chunk: int = 8) -> torch.Tensor:
        """Eval-mode labels [N, H, W] of a stack of images, `chunk` images
        a forward; the last chunk is padded with copies of the first image
        (each image's labels are its own in eval mode)."""
        images = self._t(images)
        n = images.shape[0]
        pad = (-n) % chunk
        if pad:
            images = torch.cat([images, images[:1].expand(pad, -1, -1, -1)])
        preds = [self.seg.infer(images[s:s + chunk])[0]
                 for s in range(0, n + pad, chunk)]
        return torch.cat(preds)[:n]

    def _seg_update(self, images, labels, generator):
        """One seg Adam step at lr_seg on the assembled batch: dropout on,
        the CE over all its pixels. Returns the loss."""
        return self.seg.update(images, labels, self.lr_seg, generator)[0]

    # ---------------------------------------------------------- occupancy
    def init_occupancy(self) -> torch.Tensor | None:
        """A fresh grid (the slab counter back to 0), or None under
        nerf.use_occupancy: false."""
        if not self.use_occupancy:
            self.nerf._occ_slab = 0
            return None
        return self.nerf.init_occupancy()

    def update_occupancy(self, grid, generator=None, jitter=None):
        """The refresh of the next rotating slab (one counter, shared with
        nerf_fit_epoch's refreshes); None without a grid."""
        if grid is None:
            return None
        return self.nerf.update_occupancy(grid, generator, jitter)

    # --------------------------------------------------------- nerf update
    def fused_image_step(self, images, labels, depths, poses, intrinsics,
                         one_m_to_scene_uom, generator, occ_grid,
                         draws=None) -> dict:
        """One Adam step on n_rays random rays from EACH of the B images,
        concatenated into one B·n_rays batch, each ray with its image's
        one_m_to_scene_uom (the JAX package's `fused_image_step` mode: the
        gradient of the mean loss at one set of parameters, one moment
        update). draws: NeRFTrainer.draw(generator, B)'s format."""
        b, n = images.shape[0], self.nerf.n_rays
        if draws is None:
            draws = self.nerf.draw(generator, b)
        rays = [self.nerf.sample_rays(
            {"pose": poses[k], "intrinsics": intrinsics[k],
             "image": images[k], "label": labels[k], "depth": depths[k]},
            draws["inds"][k * n:(k + 1) * n]) for k in range(b)]
        rays = {key: torch.cat([r[key] for r in rays]) for key in rays[0]}
        return self.nerf.step_on_rays(
            rays, draws["u_coarse"], draws["u_fine"], occ_grid,
            one_m_to_scene_uom.repeat_interleave(n))

    def _nerf_update_all(self, new, labels, generator, occ_grid, draws):
        """The B images' NeRF updates (per image, or fused); returns the
        image-mean loss parts. draws: a list of B per-image draws, or one
        fused draw."""
        args = (new["img"], labels, new["depth"], new["pose"],
                new["intrinsics"], new["one_m_to_scene_uom"])
        if self.fuse_images:
            return self.fused_image_step(*args, generator, occ_grid, draws)
        parts = [self.nerf.train_step(
            {"pose": pose, "intrinsics": intr, "image": img, "label": lab,
             "depth": depth, "one_m_to_scene_uom": uom}, generator, occ_grid,
            None if draws is None else draws[k])
            for k, (img, lab, depth, pose, intr, uom) in enumerate(
                zip(*args))]
        return _mean_parts(parts)

    def _batch(self, batch: dict) -> dict:
        """A new-scene batch's arrays as f32 tensors on the device: img [B,
        H, W, 3], depth [B, H, W], pose [B, 4, 4], intrinsics [B, 4],
        one_m_to_scene_uom [B]."""
        return {k: self._t(batch[k], torch.float32)
                for k in ("img", "depth", "pose", "intrinsics",
                          "one_m_to_scene_uom")}

    def nerf_fit_step(self, batch: dict, generator, occ_grid=None,
                      draws=None) -> dict:
        """Phase-1 step: eval-mode pseudo-labels (no BN update), then the
        NeRF updates of the batch's images. Returns the image-mean loss
        parts."""
        new = self._batch(batch)
        pseudo, _ = self.seg.infer(new["img"])
        return self._nerf_update_all(new, pseudo, generator, occ_grid, draws)

    def nerf_fit_epoch(self, buffers: dict, order, generator, occ_step: int,
                       occ_grid=None, draws=None):
        """One phase-1 epoch: a NeRF update on each image of `order` (the
        buffers' arrays as nerf_fit_step's batch, and pseudo [N, H, W] from
        seg_pseudo_labels), and after every step that brings occ_step to a
        multiple of nerf.occ_cfg.update_every, the refresh of the next
        slab. draws: {"steps": each step's draws as the NeRF updates take
        them (a one-image list, or a fused draw), "refresh": one jitter per
        refresh} to replay another package's. Returns
        (occ_grid, occ_step, the epoch-mean loss parts)."""
        bufs = self._batch(buffers)
        pseudo = self._t(buffers["pseudo"])
        refresh = iter(draws["refresh"]) if draws is not None else None
        parts = []
        for s, i in enumerate(int(i) for i in order):
            one = {k: v[i:i + 1] for k, v in bufs.items()}
            parts.append(self._nerf_update_all(
                one, pseudo[i:i + 1], generator, occ_grid,
                None if draws is None else draws["steps"][s]))
            occ_step += 1
            if occ_grid is not None and \
                    occ_step % self.nerf.occ_cfg.update_every == 0:
                occ_grid = self.update_occupancy(
                    occ_grid, generator,
                    None if refresh is None else next(refresh))
        return occ_grid, occ_step, _mean_parts(parts)

    # ------------------------------------------------------------- render
    def _cfg(self, which: str) -> RenderConfig:
        if which == "test":
            return self.test_cfg
        if which == "predict":
            return self.predict_cfg
        raise ValueError(f"which must be 'test' or 'predict', not {which!r}")

    def packed_for(self, cfg: RenderConfig | None = None):
        """The NeRF's packed render table under cfg (the test config by
        default), packed once per table version (NeRFTrainer.packed_for),
        or None where packing is off."""
        return self.nerf.packed_for(cfg or self.test_cfg)

    @torch.no_grad()
    def _render(self, poses, intrinsics, occ_grid, cfg) -> dict:
        """G frames' rays in one staged render (frames share 4096-ray
        chunks, as in the JAX package's batched render) through cfg's
        packed table."""
        rays = [get_rays(p, intrinsics, self.H, self.W, device=self.device)
                for p in poses]
        out = render_rays_staged(
            self.nerf.model, torch.cat([r["rays_o"] for r in rays]),
            torch.cat([r["rays_d"] for r in rays]),
            torch.cat([r["direction_norms"] for r in rays]), cfg, occ_grid,
            self.packed_for(cfg), self.mesh)
        # rays with no semantic mass renormalise to uniform and keep their
        # argmax (class 0), as the reference's predict dumps them
        sem, _ = normalize_semantics(out["semantics"])
        g, H, W = len(rays), self.H, self.W
        return {"nerf_rgb": out["image"].reshape(g, H, W, 3),
                "nerf_semantics": sem.argmax(dim=-1).reshape(g, H, W),
                "nerf_semantics_raw": sem.reshape(g, H, W, -1),
                "nerf_depth": out["depth"].reshape(g, H, W)}

    def render_frames(self, poses, intrinsics, occ_grid=None, group: int = 4,
                      which: str = "test") -> dict:
        """Full-frame renders of B poses [B, 4, 4] with one intrinsics [4],
        `group` frames a staged render, at the test or predict budget:
        nerf_rgb [B, H, W, 3], nerf_semantics (argmax) [B, H, W],
        nerf_semantics_raw [B, H, W, C], nerf_depth [B, H, W]."""
        cfg = self._cfg(which)
        poses = self._t(poses, torch.float32)
        outs = [self._render(poses[s:s + group], intrinsics, occ_grid, cfg)
                for s in range(0, poses.shape[0], group)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _render_frame(self, pose, intrinsics, occ_grid, which: str) -> dict:
        """One frame; `which` ("test" | "predict") is required, so that no
        metrics path gets the predict budget by default."""
        out = self._render(self._t(pose, torch.float32)[None], intrinsics,
                           occ_grid, self._cfg(which))
        return {k: v[0] for k, v in out.items()}

    # ------------------------------------------------------- augmentation
    def _augment_rendered(self, rgbs, labels, generator, params=None):
        """Jitter, rotate, crop and flip the rendered images and their
        labels (shifted +1 into float, so that the rotation's fill 0 is
        unknown, then back to int with -1 unknown)."""
        if params is None:
            params = draw_augment_params(generator, rgbs.shape[0],
                                         (self.H, self.W), (self.H, self.W),
                                         device=self.device)
        img, (lab,) = augment(rgbs, [(labels + 1).float()], params,
                              out_hw=(self.H, self.W))
        return img, lab.long() - 1

    # ============================================================== phases
    def joint_step(self, batch_old, batch_new, batch_cl, generator,
                   occ_grid=None, draws=None) -> dict:
        """Phase-2 step. batch_new: nerf_fit_step's batch (B images);
        batch_old: img [b, H, W, 3], nerf_label [b, H, W]; batch_cl:
        replay_img [b, k, H, W, 3], replay_label [b, k, H, W]; any of them
        may be None, not all. draws: {"nerf": the NeRF updates' draws (a
        list per image, or one fused draw), "augment": the augmentation's
        params} to replay another package's; the seg step's dropout draws
        from `generator`. Returns the logs: loss_seg and, when the NeRF
        was updated, the image-mean NeRF loss parts."""
        draws = draws or {}
        logs, imgs, labels = {}, [], []
        if batch_new is not None:
            new = self._batch(batch_new)
            # every frame with the first image's intrinsics, as JAX does
            rendered = self._render(new["pose"], new["intrinsics"][0],
                                    occ_grid, self.test_cfg)
            if not self.fix_nerf:
                b = new["img"].shape[0]
                pseudo, _ = self.seg.infer(new["img"], update_bn=b > 1)
                logs.update(self._nerf_update_all(
                    new, pseudo, generator, occ_grid, draws.get("nerf")))
            aug_rgb, aug_label = self._augment_rendered(
                rendered["nerf_rgb"], rendered["nerf_semantics"], generator,
                draws.get("augment"))
            imgs.append(aug_rgb)
            labels.append(aug_label)
        if batch_old is not None:
            imgs.append(self._t(batch_old["img"], torch.float32))
            labels.append(self._t(batch_old["nerf_label"]).long())
        if batch_cl is not None:
            r_img = self._t(batch_cl["replay_img"], torch.float32)
            r_lab = self._t(batch_cl["replay_label"]).long()
            imgs.append(r_img.reshape(-1, *r_img.shape[2:]))
            labels.append(r_lab.reshape(-1, *r_lab.shape[2:]))
        if not imgs:
            raise ValueError("joint_step needs at least one batch")
        logs["loss_seg"] = self._seg_update(torch.cat(imgs),
                                            torch.cat(labels), generator)
        return logs

    def predict_frame(self, pose, intrinsics, image=None,
                      occ_grid=None) -> dict:
        """A render at the predict budget, and seg_semantics [H, W]: the seg
        net's eval-mode labels of `image` [H, W, 3], or of the render
        itself (a novel viewpoint) when no image is given."""
        out = self._render_frame(pose, intrinsics, occ_grid, "predict")
        seg_in = (out["nerf_rgb"] if image is None
                  else self._t(image, torch.float32))
        out["seg_semantics"] = self.seg.infer(seg_in[None])[0][0]
        return out
