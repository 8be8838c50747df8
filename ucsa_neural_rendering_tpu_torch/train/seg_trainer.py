"""DeepLabV3 segmentation training (counterpart of
ucsa_neural_rendering_tpu/train/seg_trainer.py):
  * loss: softmax cross-entropy with -1 ignored, summed over the valid
    pixels and divided by ALL pixels (the reference's
    `F.cross_entropy(..., reduction="none").mean()`); `double_softmax`
    reproduces the reference's quirk of passing softmax probabilities to
    F.cross_entropy;
  * optimizers: Adam / SGD / Adadelta / RMSprop by config, with the JAX
    package's (optax's) semantics; the POLY factor, epoch-granular, is the
    caller's;
  * the BN-trick inference of the joint step (BN batch stats with updates,
    dropout off).

The trainer owns the model and its optimizer and updates them in place (the
JAX package threads params, batch stats and optimizer state through pure
functions). Dropout draws from the caller's torch.Generator where the JAX
package takes a key. Images enter as the JAX package takes them, [B, H, W,
3] in [0, 1], and are permuted to NCHW once here; logits and probabilities
leave NCHW, [B, C, H, W].

Data parallelism (`mesh=`, a parallel.Mesh; JAX `seg_trainer.py:121-146`):
a batch whose size the world size divides is sharded, each rank taking
its block (`sharded=True`: the caller passes this rank's block of a
global batch of size·B rows, as the pretrain loop's split loading reads
it); BatchNorm takes the global batch's statistics and dropout the global
batch's mask (parallel.sharded_batch); the CE divides each rank's sum by
the global pixel count; the gradients are summed over the ranks before
the step and the confusion matrix after it. A batch the world size does
not divide runs replicated: every rank computes it whole, with its CE
divided by the world size, so the summed gradient is the batch's and the
ranks stay equal. The loss returned is the global one on every rank.
"""

import torch

from ..metrics.meter import confusion_matrix_update
from ..parallel.mesh import shard_batch, sharded_batch, unshard
from ..utils.device import resolve_device


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         double_softmax: bool = False,
                         denom=None) -> torch.Tensor:
    """logits [B, C, H, W] (class axis 1), labels [B, H, W] int (-1
    ignore) → the CE summed over the valid pixels divided by `denom`
    (default: all pixels, labels.numel()). Callers whose batch carries
    padding rows pass the real batch's pixel count. double_softmax=True
    applies log_softmax to softmax(logits), the reference's quirk."""
    num_classes = logits.shape[1]
    if double_softmax:
        logits = torch.softmax(logits, dim=1)
    logp = torch.log_softmax(logits, dim=1)
    labels = labels.long()
    picked = torch.gather(logp, 1,
                          labels.clamp(0, num_classes - 1)[:, None])[:, 0]
    if denom is None:
        denom = labels.numel()
    return torch.where(labels >= 0, -picked,
                       torch.zeros_like(picked)).sum() / denom


def make_seg_optimizer(params, cfg_optimizer: dict,
                       lr_key: str = "lr") -> torch.optim.Optimizer:
    """The JAX package's optimizer zoo as torch.optim over `params`:
      * Adam: optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8 outside
        the sqrt) = torch's;
      * SGD: optax's add_decayed_weights then sgd(momentum) = torch SGD's
        weight_decay with momentum, dampening 0 (sgd_cfg: weight_decay 0,
        momentum 0.9 unless given);
      * Adadelta: optax's rho 0.9, eps 1e-6 = torch's;
      * RMSprop: the JAX package's transcription of torch's, alpha 0.99,
        eps 1e-8 outside the sqrt, momentum 0.9.
    The learning rate is cfg_optimizer[lr_key]; SegTrainer.update sets
    each step's."""
    name = cfg_optimizer.get("name", "Adam")
    lr = float(cfg_optimizer[lr_key])
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "SGD":
        sgd = cfg_optimizer.get("sgd_cfg", {})
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(sgd.get("momentum", 0.9)),
                               weight_decay=float(sgd.get("weight_decay",
                                                          0.0)))
    if name == "Adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    if name == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                   momentum=0.9)
    raise ValueError(f"unknown optimizer {name}")


def poly_lr_factor(epoch: int, max_epochs: int, power: float,
                   init_lr: float, target_lr: float) -> float:
    """POLY schedule, epoch-granular (the reference's
    semantics_lightning_net.py:181-185):
    lr(e) = init · [frac^p + (1 − frac^p) · target / init],
    frac = (max_e − min(max_e, e)) / max_e."""
    frac = (max_epochs - min(max_epochs, epoch)) / max_epochs
    return init_lr * (frac ** power + (1 - frac ** power) * target_lr
                      / init_lr)


class SegTrainer:
    def __init__(self, model, cfg_optimizer: dict, lr_key: str = "lr",
                 double_softmax: bool = False, device="cuda", mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.model = model.to(self.device)
        self.cfg_optimizer = cfg_optimizer
        self.lr_key = lr_key
        self.double_softmax = double_softmax
        self.optimizer = None

    def init(self, state=None) -> torch.optim.Optimizer:
        """Load `state` (a DeepLabV3 state dict, e.g. from
        models.convert.deeplab_state_from_jax) when given, and start a fresh
        optimizer."""
        if state is not None:
            self.model.load_state_dict(state)
        self.optimizer = make_seg_optimizer(self.model.parameters(),
                                            self.cfg_optimizer, self.lr_key)
        return self.optimizer

    def _nchw(self, images: torch.Tensor) -> torch.Tensor:
        return images.to(self.device).permute(0, 3, 1, 2).contiguous()

    def _split(self, images, labels, sharded: bool):
        """(images, labels, global batch size, whether sharded) of this
        rank under the mesh (module docstring)."""
        mesh = self.mesh
        if mesh is None:
            return images, labels, labels.shape[0], False
        if sharded:
            return images, labels, labels.shape[0] * mesh.size, True
        if mesh.block(labels.shape[0]) is None:
            return images, labels, labels.shape[0], False
        return (*shard_batch((images, labels), mesh), labels.shape[0],
                True)

    def update(self, images: torch.Tensor, labels: torch.Tensor, lr,
               generator: torch.Generator | None, n_real=None,
               sharded: bool = False):
        """One optimizer step on the model in place: forward in train mode
        (BN batch stats with updates, dropout from `generator`), the CE
        over n_real·H·W pixels (n_real: the real images of the global
        batch when it carries padding rows with -1 labels; default all B),
        backward, and the step at learning rate `lr` (the caller's POLY
        schedule, or the joint step's fixed lr_seg). images [B, H, W, 3] in
        [0, 1], labels [B, H, W] int (-1 ignore); under a mesh the global
        batch, or this rank's block of it with sharded=True. Returns (the
        global batch's loss, this rank's forward's logits [b, C, H, W],
        detached, and its labels), tensors on the device, not
        synchronised."""
        if self.optimizer is None:
            self.init()
        labels = labels.to(self.device)
        images, labels, B, sharded = self._split(images, labels, sharded)
        H, W = labels.shape[1:]
        self.model.train()
        with sharded_batch(self.mesh if sharded else None):
            logits = self.model(self._nchw(images), generator)["out"]
        b = B if n_real is None else n_real
        # replicated under a mesh: each rank holds 1/size of the loss
        copies = 1 if self.mesh is None or sharded else self.mesh.size
        loss = cross_entropy_ignore(logits, labels, self.double_softmax,
                                    denom=b * H * W * copies)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            self.mesh.all_reduce_grads(self.model.parameters())
            loss = self.mesh.all_reduce_(loss.clone())
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return loss, logits.detach(), labels

    def train_step(self, images: torch.Tensor, labels: torch.Tensor, lr,
                   generator: torch.Generator | None, n_real=None,
                   sharded: bool = False):
        """`update`, then the confusion matrix of its forward: returns
        (loss, confusion matrix [C, C] int32 of the argmax of the logits,
        summed over the ranks under a mesh), tensors on the device, not
        synchronised."""
        # a replicated batch's matrix is already the whole batch's
        summed = self.mesh is not None and (
            sharded or self.mesh.block(labels.shape[0]) is not None)
        loss, logits, labels = self.update(images, labels, lr, generator,
                                           n_real, sharded)
        conf = confusion_matrix_update(logits.argmax(dim=1), labels,
                                       self.model.num_classes)
        if summed:
            conf = self.mesh.all_reduce_(conf)
        return loss, conf

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor):
        """Eval mode (BN running stats, dropout off) → (argmax preds [B, H,
        W], logits [B, C, H, W])."""
        self.model.eval()
        logits = self.model(self._nchw(images))["out"]
        return torch.softmax(logits, dim=1).argmax(dim=1), logits

    @torch.no_grad()
    def infer(self, images: torch.Tensor, update_bn: bool = False):
        """The joint step's seg forward (JAX JointTrainer._seg_infer_impl):
        dropout off; with update_bn, the BN trick (BN batch stats, running
        stats updated, as the reference's eval() + BN train()), else eval
        mode. Returns (argmax preds [B, H, W], softmax probs [B, C, H,
        W]). Under a mesh the BN trick shards a batch the world size
        divides (global BN statistics, the outputs gathered); an eval-mode
        forward, image by image, runs replicated."""
        self.model.set_mode(use_running_average=not update_bn,
                            deterministic=True)
        sl = None if self.mesh is None or not update_bn \
            else self.mesh.block(images.shape[0])
        if sl is None:
            probs = torch.softmax(self.model(self._nchw(images))["out"],
                                  dim=1)
            return probs.argmax(dim=1), probs
        with sharded_batch(self.mesh):
            probs = torch.softmax(self.model(self._nchw(images[sl]))["out"],
                                  dim=1)
        probs = unshard(probs, self.mesh)
        return probs.argmax(dim=1), probs
