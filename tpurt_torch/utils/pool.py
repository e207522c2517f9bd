"""Buddy sub-allocator over a linear arena — port of
``tpurt/utils/pool.py:BuddySubAllocator`` (its pure-Python twin).

The reference suballocates its model and texture buffers from large
backing allocations with a power-of-two buddy (vk_buffers_suballocator.rs:
size-keyed free lists, recursive split on allocate, buddy merge on free).
Here it manages slot lifetimes inside one preallocated tensor: the
streaming-texture arena (``engine/texture_arena.py``) allocates image rows
from it. tpurt also carries a C++ twin that returns the same offsets; it
runs a few dozen times per residency change and on no per-frame path, so
the port keeps only this one.
"""
from __future__ import annotations


class BuddySubAllocator:
    def __init__(self, total_size: int, min_block: int = 256):
        mb = 1
        while mb < min_block:
            mb <<= 1
        tot = mb
        while tot * 2 <= total_size:
            tot <<= 1
        self.min_block = mb
        self.total = tot
        self._orders = (tot // mb).bit_length()
        self._free = [set() for _ in range(self._orders)]
        self._free[-1].add(0)
        self._live = {}

    def _order_of(self, size: int) -> int:
        b, o = self.min_block, 0
        while b < size:
            b <<= 1
            o += 1
        return o

    def _order_size(self, o: int) -> int:
        return self.min_block << o

    def allocate(self, size: int, alignment: int = 1) -> int:
        """Returns the arena offset, or raises MemoryError. Power-of-two
        blocks are naturally aligned to their size."""
        size = max(size, alignment, 1)
        want = self._order_of(size)
        if want >= self._orders:
            raise MemoryError("allocation larger than arena")
        o = want
        while o < self._orders and not self._free[o]:
            o += 1
        if o == self._orders:
            raise MemoryError("arena exhausted")
        off = self._free[o].pop()
        while o > want:  # recursive split (vk_buffers_suballocator.rs:208-232)
            o -= 1
            self._free[o].add(off + self._order_size(o))
        self._live[off] = want
        return off

    def free(self, offset: int):
        order = self._live.pop(offset, None)
        if order is None:
            raise ValueError(f"offset {offset} not allocated")
        off, o = offset, order
        while o + 1 < self._orders:  # buddy merge (:235-272)
            buddy = off ^ self._order_size(o)
            if buddy not in self._free[o]:
                break
            self._free[o].discard(buddy)
            off = min(off, buddy)
            o += 1
        self._free[o].add(off)

    def free_bytes(self) -> int:
        return sum(len(s) * self._order_size(o)
                   for o, s in enumerate(self._free))
