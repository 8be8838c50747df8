"""Data parallelism over torch.distributed (counterpart of
ucsa_neural_rendering_tpu/parallel/mesh.py).

The reference distributes only by Lightning DDP (ref: scripts/pretrain.py:
103-109); the JAX package expresses the same as a one-axis mesh, the batch
or ray axis sharded and the parameters replicated. Here, in PyTorch's
idiom, the mesh is the process group: one process per device, NCCL between
cards, gloo on the CPU. A `Mesh` holds the group, this process's rank, the
world size and the device, and does the collectives the trainers need.

JAX's `data_sharding` / `replicated_sharding` have no torch object. The
blocking rule stands in for them: a leading axis of n rows is sharded when
the world size divides n, rank r holding the contiguous rows [r·n/w,
(r+1)·n/w); otherwise every rank holds all n rows (replicated, as JAX's
sharding constraint is skipped for such an axis). Parameters are
replicated: every rank applies the same update from gradients summed over
the ranks, so they stay bit-identical.

Ranks start from the launcher's environment (`python -m
torch.distributed.run` sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT), or from a process group the caller initialised (the tests
spawn their ranks and pass a `file://` store). A group the caller
initialised keeps its backend: gloo, say, for two ranks that share one
card, which NCCL refuses.
"""

import contextlib
import contextvars
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the data-parallel group (the default group)."""
    rank: int
    size: int
    device: torch.device
    backend: str

    # ------------------------------------------------------------ blocking
    def block(self, n: int) -> slice | None:
        """This rank's rows of a leading axis of n rows: a slice when the
        world size divides n, None when the axis runs replicated."""
        if n % self.size:
            return None
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """x's rows on this rank (all of them when the axis is
        replicated)."""
        sl = self.block(x.shape[0])
        return x if sl is None else x[sl]

    # --------------------------------------------------------- collectives
    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks, in place; every rank gets the same
        bits."""
        dist.all_reduce(x)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(x, src)
        return x

    def barrier(self):
        # a barrier as a one-element all-reduce on the mesh's device: NCCL's
        # own barrier guesses the device from the rank
        self.all_reduce_(torch.zeros(1, device=self.device))

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of equal shape, concatenated along dim 0 in
        rank order (every rank gets the whole). gloo gathers no CUDA
        tensors, so there each rank writes its block into a zero-filled
        buffer of the whole and the buffers are summed: the same rows,
        exactly (x + 0 = x)."""
        if self.size == 1:
            return x
        if x.dtype == torch.bool:
            return self.all_gather_rows(x.to(torch.uint8)).bool()
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        if self.backend == "gloo" and x.is_cuda:
            out.zero_()
            k = x.shape[0]
            out[self.rank * k:(self.rank + 1) * k] = x
            return self.all_reduce_(out)
        if self.backend == "gloo":
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x)
            return torch.cat(parts)
        dist.all_gather_into_tensor(out, x)
        return out

    def all_reduce_grads(self, params):
        """Sum the .grad of `params` over the ranks, in one flat buffer per
        dtype. Parameters without a gradient are left out (every rank has
        the same graph, so the same ones)."""
        grads = [p.grad for p in params if p.grad is not None]
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            self.all_reduce_(flat)
            s = 0
            for g in group:
                g.copy_(flat[s:s + g.numel()].view_as(g))
                s += g.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks with a gradient: the backward sums the incoming
    gradients over the ranks too (each rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the ranks, differentiable (synced BatchNorm)."""
    return _AllReduceSum.apply(x, mesh)


# the mesh over which the batch a model is running on is sharded, while a
# trainer holds `sharded_batch` open: BatchNorm takes global statistics and
# dropout draws the global batch's mask and keeps this rank's block
_BATCH_MESH = contextvars.ContextVar("batch_mesh", default=None)


@contextlib.contextmanager
def sharded_batch(mesh: Mesh | None):
    """Within this block the models' forward sees this rank's block of a
    batch sharded over `mesh`. A mesh of one rank, or None, changes
    nothing: a one-rank block is the whole batch."""
    token = _BATCH_MESH.set(mesh if mesh is not None and mesh.size > 1
                            else None)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def batch_mesh() -> Mesh | None:
    """The mesh of `sharded_batch`, or None outside it."""
    return _BATCH_MESH.get()


def world_size_from_env() -> int:
    """WORLD_SIZE as the launcher sets it (1 without a launcher)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device_count(device_type: str = "cuda") -> int:
    """The devices of this host a rank can take: the cards, or 1 for the
    CPU."""
    if device_type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


_MESH = None


def get_mesh(device="cuda") -> Mesh:
    """This process's Mesh. Initialises the default process group from the
    launcher's environment unless the caller already did: nccl on a card,
    gloo on the CPU. device: "cuda" (the card LOCAL_RANK, modulo the cards
    this host has) or "cpu" (or a torch.device)."""
    global _MESH
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the ranks "
                "on the CPU over gloo")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    backend = dist.get_backend()
    if (_MESH is None or _MESH.device != device
            or _MESH.backend != backend or _MESH.rank != dist.get_rank()
            or _MESH.size != dist.get_world_size()):
        _MESH = Mesh(dist.get_rank(), dist.get_world_size(), device,
                     backend)
    return _MESH


def mesh_from_env(device) -> Mesh | None:
    """The loops' rule (JAX builds a mesh when jax.device_count() > 1): a
    Mesh when the launcher started more than one rank, or when a process
    group is already up, else None (one rank, no collectives)."""
    if world_size_from_env() > 1 or (dist.is_available()
                                     and dist.is_initialized()):
        return get_mesh(device)
    return None


def shard_batch(batch, mesh: Mesh):
    """This rank's block of every tensor's leading axis in a (nested)
    dict / tuple / list of tensors, as JAX's shard_batch places each leaf
    sharded on the mesh."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return mesh.shard(batch)


def unshard(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The whole of a sharded leading axis (every rank's block, in rank
    order); x itself without a mesh."""
    return x if mesh is None else mesh.all_gather_rows(x)


def shutdown():
    """Destroy the default process group, where one is up."""
    global _MESH
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None
