"""Data parallelism over ranks: the mesh, each rank's rows, the collectives.

Port of the JAX package's ``parallel/mesh.py``. There one program runs over
a 1-D ``data`` mesh of devices: the episode batch is sharded on its leading
axis, ``norm_mean``/``norm_std`` and the parameters are replicated, and XLA
inserts the collectives, so every loss divides by counts taken over the
whole global batch. Here each rank is a process (``torchrun``), and the
collectives are explicit:

  * ``make_mesh`` → a ``Mesh``: rank, world size, local rank, device and
    process group (None for one rank without ``torchrun``: no collective
    runs at all);
  * ``shard_batch``: this rank's rows of a global batch, uploaded;
  * ``replicate``: rank 0's parameters and buffers on every rank;
  * ``global_sum``/``global_max``: the counts and diagnostics of the
    global batch; ``sum_gradients``: the gradient of the global loss;
    ``all_gather_rows``: a per-rank result put back in global row order.

Backends, with no silent alternative: NCCL when each rank of a host has its
own card; ranks that share a card only over gloo, and only when the caller
asks for it (``backend="gloo"``, ``--backend gloo``), because NCCL refuses
two ranks on one device; gloo on the CPU. A rank that finds no GPU raises
instead of moving to the CPU. Gloo runs every collective used here
(``all_reduce`` SUM and MAX, ``broadcast``, ``all_gather``, ``barrier``,
the object collectives) on CUDA tensors itself, through host memory
(``chip_smoke.py::phase_dp`` checks each on the card), so this module has
no host round trip of its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

from fgn_torch.data.batching import EpisodeBatch

# EpisodeBatch fields that every rank holds whole (mesh.py:41 there).
REPLICATED_BATCH_FIELDS = ("norm_mean", "norm_std")

# Gradients are summed over ranks in buckets of this many elements (32 MB
# of float32), in the parameters' order.
GRAD_BUCKET_ELEMS = 1 << 23


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in the data-parallel run. ``group`` is None for a
    single rank started without ``torchrun``: every collective below is then
    the identity. A one-rank group (``torchrun --nproc_per_node 1``) runs
    its collectives."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that logs, writes checkpoints and scores."""
        return self.rank == 0


def _rank_device(device, backend: Optional[str], local_rank: int,
                 local_world: int):
    """→ (this rank's device, its backend), by the rules in the module's
    docstring."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs "
                             "there")
        return device, "gloo"
    if device.type != "cuda":
        raise ValueError(f"device {device}: want cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                           "(--device cpu) to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if local_world > cards:
        if backend != "gloo":
            raise RuntimeError(
                f"make_mesh: {local_world} ranks on this host and {cards} "
                "card(s): NCCL needs a card for each rank; pass "
                "backend='gloo' (--backend gloo) to share a card")
        return torch.device("cuda", local_rank % cards), "gloo"
    return torch.device("cuda", local_rank), backend or "nccl"


def make_mesh(backend: Optional[str] = None, device="cuda",
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """This process's ``Mesh``.

    Under ``torchrun`` the rank, world size and local rank come from its
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    variables and the rendezvous from ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``); a caller that spawns its own ranks passes ``init_method``
    (e.g. ``file://`` in a temporary directory), ``rank`` and
    ``world_size``, and all its ranks are on this host. Without either, the
    one-rank mesh on ``device``, with no process group. A process group
    that is already initialized is reused, with its backend."""
    spawned = init_method is not None
    if not (spawned or "WORLD_SIZE" in os.environ or dist.is_initialized()):
        return Mesh(device=torch.device(device))
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
        backend = backend or dist.get_backend()
    elif not spawned:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if spawned or "LOCAL_RANK" not in os.environ:
        local_rank, local_world = int(rank), int(world_size)
    else:
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev, backend = _rank_device(device, backend, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=int(rank),
            world_size=int(world_size),
            device_id=dev if backend == "nccl" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    return Mesh(int(rank), int(world_size), local_rank, dev,
                dist.group.WORLD, backend)


def close():
    """End this process's process group, if it has one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the batch ------------------------------------------------------------------


def episode_batch_shardings() -> EpisodeBatch:
    """An EpisodeBatch of ``"rows"`` (per-episode arrays: each rank takes
    its rows of the leading axis) and ``"replicated"`` (every rank holds
    the whole field)."""
    return EpisodeBatch(**{
        f: "replicated" if f in REPLICATED_BATCH_FIELDS else "rows"
        for f in EpisodeBatch._fields})


def rank_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """Rows ``[r·n/W, (r+1)·n/W)`` of a global batch of ``n``: rank r's. A
    batch that W does not divide raises, as the JAX package's sharding
    does."""
    if mesh is None or mesh.world_size == 1:
        return slice(0, n)
    if n % mesh.world_size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def batch_rows(batch: EpisodeBatch, mesh: Optional[Mesh]) -> EpisodeBatch:
    """This rank's rows of ``batch`` (numpy arrays or tensors; views)."""
    rows = rank_rows(batch.qry_img.shape[0], mesh)
    return EpisodeBatch(*(
        t if how == "replicated" else t[rows]
        for t, how in zip(batch, episode_batch_shardings())))


def shard_batch(batch: EpisodeBatch, mesh: Optional[Mesh], device=None,
                staging=None) -> EpisodeBatch:
    """This rank's rows of the global numpy ``batch`` as tensors on
    ``device`` (default the mesh's), through the evaluator's
    ``upload_batch`` (pinned buffers of ``staging`` on CUDA)."""
    from fgn_torch.train.evaluator import upload_batch

    device = device if device is not None else mesh.device
    return upload_batch(batch_rows(batch, mesh), torch.device(device), staging)


# -- collectives ------------------------------------------------------------------


def _grouped(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def global_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ of ``t`` over the ranks (``t`` itself without a group). For counts
    and diagnostics: no gradient flows through the sum."""
    if not _grouped(mesh):
        return t
    t = t.detach().clone()
    dist.all_reduce(t, dist.ReduceOp.SUM, group=mesh.group)
    return t


def global_max(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks."""
    if not _grouped(mesh):
        return t
    t = t.detach().clone()
    dist.all_reduce(t, dist.ReduceOp.MAX, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated on the
    leading axis in rank order: the global batch's rows in their order."""
    if not _grouped(mesh):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=0)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not _grouped(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Optional[Mesh]):
    if _grouped(mesh):
        dist.barrier(group=mesh.group)


def rank0_first(fn: Callable[[], Any], mesh: Optional[Mesh]):
    """``fn()`` on rank 0, then on the other ranks: what it caches on disk
    (a dataset's support bank under its ``root``), rank 0 writes and the
    others read, instead of every rank writing the same files at once."""
    if not _grouped(mesh):
        return fn()
    if mesh.is_main:
        try:
            return fn()
        finally:
            barrier(mesh)
    barrier(mesh)
    return fn()


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Rank 0's parameters and buffers, in place, on every rank."""
    if _grouped(mesh):
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


@torch.no_grad()
def sum_gradients(params: Iterable[torch.nn.Parameter], mesh: Optional[Mesh]):
    """Each parameter's ``.grad`` replaced, in place, by its sum over the
    ranks: flattened into buckets of ``GRAD_BUCKET_ELEMS`` elements in the
    parameters' order, one all-reduce each. A parameter without a gradient
    takes zeros on every rank (the optimizer reads a missing gradient as
    zeros), so all ranks reduce the same buckets."""
    if not _grouped(mesh):
        return
    bucket: List[torch.nn.Parameter] = []

    def flush():
        flat = torch.cat([p.grad.reshape(-1) for p in bucket])
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=mesh.group)
        off = 0
        for p in bucket:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()
        bucket.clear()

    size = 0
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        if bucket and (size + p.numel() > GRAD_BUCKET_ELEMS
                       or p.grad.dtype != bucket[0].grad.dtype):
            flush()
            size = 0
        bucket.append(p)
        size += p.numel()
    if bucket:
        flush()


def rank_draws(generator: torch.Generator, device, mesh: Optional[Mesh]):
    """The samplers' uniform draws for this rank: each draw is made at the
    global batch's shape, in the one-rank order, and this rank keeps its
    rows, so every rank's samplers see the bits of the one-rank run.
    → ``draws(name, shape)`` as ``FGN.train_forward`` takes it."""
    world = 1 if mesh is None else mesh.world_size

    def draws(name, shape):
        full = torch.rand((shape[0] * world,) + tuple(shape[1:]),
                          generator=generator, device=device)
        return full[rank_rows(full.shape[0], mesh)]

    return draws
