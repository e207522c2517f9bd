"""Streaming-texture row arena — port of ``tpurt/engine/texture_arena.py``.

The reference suballocates its texture buffers from large backing
allocations (vk_buffers_suballocator.rs:84-146) so that streaming does not
reallocate device memory. Here the texel rows of every resident unique
image live inside ONE persistent (capacity, row_width) tensor on the
renderer's device, its slots managed by ``utils/pool.BuddySubAllocator``
in row units. When the resident model set changes the renderer flattens
the scene anew on the host, but rows already resident keep their offsets:
only joining images upload (slice assignment into the existing tensor) and
leaving images free their slots first.

Capacity is a power of two of at least ``_MIN_BLOCK_ROWS`` rows; it
doubles on growth (or when the buddy cannot place a chunk), and then the
whole working set uploads again. Keys are content hashes of the rows
(the caller's SHA-1), so an image shared by many primitives is stored
once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.pool import BuddySubAllocator

# buddy granularity in rows: 64-byte rows -> 16 KB blocks
_MIN_BLOCK_ROWS = 256


class TextureRowArena:
    """Content-keyed row residency inside one persistent device tensor."""

    def __init__(self, row_width: int = 64, dtype=torch.uint8,
                 device="cpu"):
        self.row_width = row_width
        self.dtype = dtype
        self.device = torch.device(device)
        self.capacity = 0
        self.atlas = None            # (capacity, row_width) tensor
        self._alloc = None
        self._live = {}              # key -> (offset, rows)
        self.last_uploaded_rows = 0
        self.last_freed = 0

    def _reset(self, capacity_rows: int):
        cap = _MIN_BLOCK_ROWS
        while cap < capacity_rows:
            cap <<= 1
        self.capacity = cap
        self.atlas = torch.zeros((cap, self.row_width), dtype=self.dtype,
                                 device=self.device)
        self._alloc = BuddySubAllocator(cap, min_block=_MIN_BLOCK_ROWS)
        self._live = {}

    def ensure(self, chunks: dict) -> dict:
        """chunks: {content_key: rows} with rows an (n, row_width) numpy
        array. Frees every resident key not in `chunks`, uploads every key
        not yet resident and returns {key: row_offset}. The counts of this
        call are ``last_uploaded_rows`` and ``last_freed`` (keys)."""
        total = sum(int(r.shape[0]) for r in chunks.values())
        if self.atlas is None or total > self.capacity:
            self._reset(max(total, 1))

        # free leavers first (their buddies may merge for the joiners)
        self.last_freed = 0
        for k in list(self._live):
            if k not in chunks:
                off, _ = self._live.pop(k)
                self._alloc.free(off)
                self.last_freed += 1

        while True:
            self.last_uploaded_rows = 0
            out = self._place(chunks)
            if out is not None:
                return out
            # fragmentation or growth: double the capacity and upload the
            # whole working set again (rare)
            self._reset(self.capacity * 2)

    def _place(self, chunks: dict):
        """Offsets of every chunk, uploading the ones not resident; None
        when the buddy cannot place one."""
        out = {}
        for k, rows in chunks.items():
            if k in self._live:
                out[k] = self._live[k][0]
                continue
            n = int(rows.shape[0])
            try:
                off = self._alloc.allocate(max(n, 1))
            except MemoryError:
                return None
            self.atlas[off:off + n] = torch.from_numpy(
                np.ascontiguousarray(rows)).to(self.device)
            self._live[k] = (off, n)
            self.last_uploaded_rows += n
            out[k] = off
        return out
