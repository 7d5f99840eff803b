"""Joining the process group, launching ranks, and the batch helpers
(counterpart of ``bliss_gnn_tpu/parallel/multihost.py``).

- :func:`initialize` joins the group a launcher described (torchrun's
  ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or one
  given a store; in a single process it is a no-op that returns False;
- :func:`run_ranks` starts N ranks of this host itself, with
  ``torch.multiprocessing`` and a ``FileStore`` (what the CLI's ``--dp``
  does with no group running);
- the global-array helpers: every rank holds the same host array (the
  same seeded construction), and takes its contiguous slice along the
  sharded dims. The JAX package assembles those slices into one global
  array; here each rank's slice is all it ever holds.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pick_backend,
    rank_device,
    ranks_per_card,
)


def initialize(device="cuda", store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> bool:
    """Joins the process group: from ``store``/``rank``/``world_size`` when
    given, else from the launcher's environment. True when a group runs
    afterwards; False (nothing done) in a single process. The backend is
    chosen from the ranks per card (``mesh.pick_backend``) and printed.
    Under NCCL the rank's card (``mesh.rank_device``) is made current
    before the group exists and handed to it as ``device_id``, so that the
    communicators bind that card and nothing of the rank lands on card 0."""
    if dist.is_initialized():
        return True
    world = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and store is None:
        return False
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = pick_backend(dev, ranks_per_card(dev, local_world))
    kw = {}
    if backend == "nccl":
        card = rank_device(dev, local_rank, local_world)
        torch.cuda.set_device(card)
        kw["device_id"] = card
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, **kw)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, **kw)
    if rank == 0:
        print(f"[multihost] joined {world} ranks, backend {backend}",
              flush=True)
    return True


def global_mesh(axis_names: Sequence[str] = ("dp",), device="cuda") -> Mesh:
    """The mesh over every rank of the group."""
    return make_mesh(None, axis_names, device=device)


def _rank_and_size(mesh: Optional[Mesh] = None):
    if mesh is not None:
        return mesh.rank, mesh.size
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None
                      ) -> slice:
    """This rank's contiguous slice of a global seed batch."""
    i, n = _rank_and_size(mesh)
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def global_array(mesh: Mesh, arr, sharded_dims: Sequence[int] = ()
                 ) -> torch.Tensor:
    """This rank's part of a host-replicated array: its contiguous slice
    along each dim of ``sharded_dims`` (the dims the JAX spec names the
    axis on), on the mesh's device."""
    t = torch.as_tensor(np.ascontiguousarray(arr)) \
        if isinstance(arr, np.ndarray) else torch.as_tensor(arr)
    for d in sharded_dims:
        d = d % t.dim()
        per = t.shape[d] // mesh.size
        t = t.narrow(d, mesh.rank * per, per)
    return t.contiguous().to(mesh.device)


def global_seed_batch(mesh: Mesh, arr, batch_dim: int = -1) -> torch.Tensor:
    """This rank's slice of a host-replicated global seed batch (or mask)
    along ``batch_dim``."""
    return global_array(mesh, arr, (batch_dim,))


def global_tree(mesh: Mesh, tree, dims_tree):
    """:func:`global_array` over nested dicts, lists and tuples; a
    ``dims_tree`` leaf (a tuple of ints) covering a subtree applies to
    each of its leaves, as a prefix spec does under ``shard_map``."""
    def is_dims(x):
        return isinstance(x, tuple) and all(isinstance(d, int) for d in x)

    def go(t, dims):
        if isinstance(t, dict):
            return {k: go(v, dims if is_dims(dims) else dims[k])
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, dims if is_dims(dims) else dims[i])
                           for i, v in enumerate(t))
        return global_array(mesh, t, dims)

    return go(tree, dims_tree)


def _rank_entry(rank: int, fn: Callable, world: int, store_path: str,
                out_dir: str, device: str, threads: Optional[int],
                args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize(device, store=dist.FileStore(store_path, world), rank=rank,
               world_size=world)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        # every rank done with its collectives before any rank closes its
        # connections; a rank that raised skips it (run_ranks then stops
        # the others and raises its traceback)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: tuple = (),
              device="cuda", workdir: Optional[str] = None,
              threads: Optional[int] = 1) -> List[Any]:
    """Runs ``fn(*args)`` on ``world_size`` ranks of this host, each a
    spawned process that has joined one group through a ``FileStore``
    under ``workdir`` (a new temporary directory by default); returns each
    rank's result (``torch.save``-able), in rank order. ``fn`` must be
    importable by name from a spawned process. A rank that raises makes
    this raise, with its traceback. ``device`` chooses the ranks' backend
    as :func:`initialize` does: the card by default (raising without
    one), ``"cpu"`` for gloo ranks on the host."""
    resolve_device(device)
    import torch.multiprocessing as mp

    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="bliss_ranks_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    store_path = os.path.join(workdir, "store")
    if os.path.exists(store_path):
        os.remove(store_path)
    try:
        mp.start_processes(
            _rank_entry, nprocs=world_size, join=True, start_method="spawn",
            args=(fn, world_size, store_path, workdir, str(device), threads,
                  tuple(args)))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        if own:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
