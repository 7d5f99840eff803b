"""The mesh of ranks and its collectives (counterpart of
``bliss_gnn_tpu/parallel/mesh.py``).

The JAX package runs one controller over S devices with ``shard_map`` and
named-axis collectives. The port runs S processes, one per rank, in one
process group. :class:`Mesh` gives that group the JAX names: its methods
are the collectives the JAX step bodies call (``jax.lax.psum(x, axis)``
becomes ``mesh.psum(x)``), all with fixed shapes, and each reports to
:mod:`commstats`.

The backend follows the ranks per card, chosen up front and printed: NCCL
at one rank per card, gloo otherwise (NCCL refuses two ranks on one card)
and on the CPU. Under gloo a collective of CUDA tensors goes through host
copies: gloo's collectives are host collectives. Such a collective cannot
be captured in a CUDA graph, so :attr:`Mesh.capturable` is False there.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
# Imported before any group of the port exists: its functions take
# ``group=group.WORLD`` as a default argument, evaluated at first import.
# Imported later (the first ``torch.optim.Adam`` does, through
# ``torch._dynamo``), they would hold the live group, so
# ``destroy_process_group`` would leave it and its gloo worker and
# transport threads running into interpreter exit, where one of them
# still finishing a work aborts the process (``terminate called without
# an active exception``).
import torch.distributed.nn  # noqa: F401

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.parallel import commstats

_MASK64 = (1 << 64) - 1


def rank_seed(seed: int, rank: int) -> int:
    """The seed of ``rank``'s generator: ``seed`` itself at rank 0, so a
    world of one draws what the one-device step draws; another rank's a
    splitmix64 mix of (seed, rank), as the JAX step folds its key by the
    axis index."""
    if rank == 0:
        return int(seed)
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(rank)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1  # a non-negative int64


def pick_backend(device: torch.device, ranks_per_card: int) -> str:
    """NCCL for CUDA ranks that each have a card of their own, else gloo."""
    return "nccl" if device.type == "cuda" and ranks_per_card == 1 else "gloo"


def local_rank_info(world_size: int) -> tuple:
    """(local rank, local world size) from the launcher's environment
    (torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``), else the global rank
    and size: the ranks of one host."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    lr = int(os.environ.get("LOCAL_RANK", rank))
    lw = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return lr, lw


def rank_device(device: torch.device, local_rank: int,
                local_world: int) -> torch.device:
    """A rank's device: the CPU, or card ``local_rank`` mod the cards."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def ranks_per_card(device: torch.device, local_world: int) -> int:
    if device.type != "cuda":
        return local_world
    return -(-local_world // torch.cuda.device_count())


class Mesh:
    """One axis over the ranks of the default process group: this rank,
    the world size, this rank's device, the axis name and the backend. The
    collectives take and return tensors on ``device``; shapes are fixed,
    as under ``shard_map``."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 axis_name: str = "dp", backend: str = "gloo",
                 owns_group: bool = False):
        self.rank, self.size = rank, size
        self.device, self.axis_name, self.backend = device, axis_name, backend
        self._owns_group = owns_group

    @property
    def capturable(self) -> bool:
        """Whether a step with this mesh's collectives can be captured in a
        CUDA graph: NCCL's run on the card's streams, gloo's on the host."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[S, *x.shape]: every rank's ``x``, in rank order."""
        x = x.contiguous()
        if self._staged(x):
            return self.all_gather(x.cpu()).to(x.device)
        flat = torch.empty(self.size * x.numel(), dtype=x.dtype,
                           device=x.device)
        dist.all_gather_into_tensor(flat, x.reshape(-1))
        out = flat.view((self.size,) + tuple(x.shape))
        commstats.record("all_gather", out)
        return out

    def _all_reduce(self, x: torch.Tensor, op, kind="all_reduce"):
        if self._staged(x):
            return self._all_reduce(x.cpu(), op).to(x.device)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op)
        commstats.record(kind, out)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [S, ...] summed over the ranks; rank r keeps row r
        (``psum_scatter(scatter_dimension=0, tiled=False)``)."""
        if x.shape[0] != self.size:
            raise ValueError(f"psum_scatter: leading dim {x.shape[0]} != "
                             f"{self.size} ranks")
        x = x.contiguous()
        if self._staged(x):
            return self.psum_scatter(x.cpu()).to(x.device)
        out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.reshape(-1))
        out = out.view(tuple(x.shape[1:]))
        commstats.record("reduce_scatter", out)
        return out

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """``x`` sent to rank (r + shift) mod S; returns what rank
        (r - shift) mod S sent (``jax.lax.ppermute`` over the ring)."""
        x = x.contiguous()
        if self.size == 1:
            return x.clone()
        if self._staged(x):
            return self.ppermute(x.cpu(), shift).to(x.device)
        out = torch.empty_like(x)
        to = (self.rank + shift) % self.size
        frm = (self.rank - shift) % self.size
        ops = [dist.P2POp(dist.isend, x, to), dist.P2POp(dist.irecv, out, frm)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        commstats.record("collective_permute", out)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def fold_seed(self, seed: int) -> int:
        return rank_seed(seed, self.rank)

    def generator(self, seed: int) -> torch.Generator:
        """This rank's generator on its device (:func:`rank_seed`)."""
        return torch.Generator(device=self.device).manual_seed(
            self.fold_seed(seed))

    def close(self) -> None:
        """Destroys the process group if :func:`make_mesh` created it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",), device="cuda") -> Mesh:
    """The mesh over the ranks of the running process group; ``n_devices``
    (None or 0: all of them) must equal its world size. With no group
    running, a world of one: a one-rank group on an in-memory store, which
    :meth:`Mesh.close` destroys. ``device`` defaults to the card (raises
    without one); ``"cpu"`` runs gloo on the host. One axis only: the JAX
    mesh's multi-axis layouts order TPU links, which one process per card
    does not have."""
    dev = resolve_device(device)
    if len(axis_names) != 1:
        raise ValueError("the port's mesh has one axis")
    owns = False
    if not dist.is_initialized():
        if n_devices not in (None, 0, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group of "
                f"{n_devices} ranks: launch with torchrun, or the CLI's "
                f"--dp (no group is running)")
        backend = pick_backend(dev, 1)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        owns = True
    world = dist.get_world_size()
    if n_devices not in (None, 0) and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks over a process group "
                         f"of {world}")
    lr, lw = local_rank_info(world)
    rdev = rank_device(dev, lr, lw)
    backend = dist.get_backend()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the mesh runs nccl or gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(rdev)
    if dist.get_rank() == 0:
        print(f"[mesh] {world} rank(s), backend {backend}, "
              f"{ranks_per_card(dev, lw)} rank(s) per "
              f"{'card' if dev.type == 'cuda' else 'host'}", flush=True)
    return Mesh(dist.get_rank(), world, rdev, axis_names[0], backend,
                owns_group=owns)
