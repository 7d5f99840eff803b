"""A direct-mapped device cache over host-resident node features
(counterpart of ``bliss_gnn_tpu/graph/featurecache.py``, the reference's
UVA plus GPU feature cache with its ``cache_miss`` statistic).

The features stay in host memory, a numpy array or a memmap that is never
uploaded whole; the device holds ``capacity`` rows and their tags. One
gather of [B] node ids runs as:

1. the probe on the device: slot = gid % capacity, a hit where the slot's
   tag is the gid;
2. the missing rows only cross to the card: their ids come to the host,
   the rows are gathered there into a pinned staging buffer (on a card),
   then one non-blocking copy;
3. the insert on the device: one winner per slot that several misses of
   the batch share, the highest batch position, so that tags and data
   agree; hits are served from the data as it was before the insert.

Direct-mapped, not LRU: the probe and insert are vectorised, and what the
cache holds changes the speed only, never the rows returned. Plain torch
(the reference's jitted jnp ops have no Pallas kernel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bliss_gnn_tpu_torch._device import resolve_device


class FeatureCache:
    """``capacity`` rows of ``host`` [N, F] (numpy array or memmap) on
    ``device`` (the card by default; raises without one), held as
    ``dtype``. ``bytes_fetched`` counts the host-to-device bytes of every
    gather."""

    def __init__(self, host: np.ndarray, capacity: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        if host.ndim != 2:
            raise ValueError("host features must be [N, F]")
        self.host = host
        self.capacity = int(min(capacity, len(host)))
        if self.capacity < 1:
            raise ValueError("the cache needs at least one row")
        self.dtype = dtype
        # one spare slot past the end takes the writes of non-winners
        self._tags = torch.full((self.capacity + 1,), -1, dtype=torch.int32,
                                device=self.device)
        self._data = torch.zeros((self.capacity + 1, host.shape[1]),
                                 dtype=dtype, device=self.device)
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None
        self._hits = self._lookups = 0
        self.bytes_fetched = 0

    @property
    def tags(self) -> torch.Tensor:
        """[capacity] int32: the gid each slot holds, -1 when empty."""
        return self._tags[:self.capacity]

    @property
    def data(self) -> torch.Tensor:
        return self._data[:self.capacity]

    @property
    def miss_rate(self) -> float:
        """Missed share of every valid lookup so far (the per-batch rate
        is ``gather``'s)."""
        if self._lookups == 0:
            return 0.0
        return 1.0 - self._hits / self._lookups

    def _fetch(self, gids: np.ndarray) -> torch.Tensor:
        """The host rows of ``gids`` on the device, in host dtype: on a
        card gathered into the pinned staging buffer and copied once,
        without a sync."""
        m, f = len(gids), self.host.shape[1]
        self.bytes_fetched += m * f * self.host.dtype.itemsize
        if self.device.type != "cuda":
            return torch.from_numpy(np.asarray(np.take(self.host, gids,
                                                       axis=0)))
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has left the buffer
        if self._staging is None or self._staging.shape[0] < m:
            self._staging = torch.empty(
                (m, f), dtype=torch.from_numpy(
                    np.empty(0, self.host.dtype)).dtype, pin_memory=True)
        buf = self._staging[:m]
        np.take(self.host, gids, axis=0, out=buf.numpy())
        rows = buf.to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return rows

    def gather(self, gids: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, float]:
        """[B, F] rows of ``dtype`` for the node ids ``gids`` [B] on the
        cache's device, zeros where ``mask`` is false, and the batch's miss
        rate over its valid ids."""
        cap = self.capacity
        gids = torch.where(mask, gids.to(torch.int32), -1)
        slots = torch.remainder(gids, cap).long()
        hit = mask & (self._tags[slots] == gids)
        miss = mask & ~hit
        # the host waits here: the missed ids and the valid count
        miss_pos = miss.nonzero().squeeze(1)
        miss_gids = gids[miss_pos].cpu().numpy().astype(np.int64)
        n_miss, n_valid = len(miss_gids), int(mask.sum())
        fetched = torch.zeros((gids.shape[0], self.host.shape[1]),
                              dtype=self.dtype, device=self.device)
        if n_miss:
            fetched[miss_pos] = self._fetch(miss_gids).to(self.dtype)
        # one winner per slot: the highest batch position among its misses
        pos = torch.arange(gids.shape[0], device=self.device)
        upd = torch.where(miss, slots, cap)
        winner = torch.full((cap + 1,), -1, dtype=torch.long,
                            device=self.device)
        winner.scatter_reduce_(0, upd, pos, "amax")
        upd = torch.where(miss & (winner[slots] == pos), slots, cap)
        out = torch.where(hit[:, None], self._data[slots], fetched)
        self._tags.index_copy_(0, upd, gids)
        self._data.index_copy_(0, upd, fetched)
        self._lookups += n_valid
        self._hits += n_valid - n_miss
        return out, n_miss / max(n_valid, 1)

    def warm(self, gids) -> None:
        """Fills the cache with the rows of ``gids`` (e.g. the nodes of
        highest degree), at most ``capacity`` of them."""
        gids = np.asarray(gids, np.int64)[:self.capacity]
        t = torch.from_numpy(gids.astype(np.int32)).to(self.device)
        self.gather(t, torch.ones(len(gids), dtype=torch.bool,
                                  device=self.device))
