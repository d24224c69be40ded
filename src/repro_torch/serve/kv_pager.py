"""Paged KV-cache manager: block-table accounting over the slot caches.

The device-resident decode cache (``serve_step.cache_shapes`` with
``global_batch == n_slots``) is a fixed-shape slot table — one batch row
per in-flight request, ``max_len`` cache positions per row.  This module
owns the HOST-side allocation state over that table:

  * **slots** — which batch row a request occupies (the decode step
    always runs the full table; the pager decides who is real);
  * **blocks** — each slot's cache length is charged against a global
    block budget in ``block`` -token pages, vLLM-style.  The budget may be
    OVERCOMMITTED (``total_blocks < n_slots * blocks_per_slot``): retired
    requests can stay resident ("cached", prefix-reuse hook) and are
    reclaimed LRU-first when a new allocation needs pages;
  * **counters** — allocs/evictions/retires/frees, peak and current
    utilization, exposed via :meth:`stats` and surfaced through the
    shared telemetry reporter (``repro_torch.core.telemetry``).

Slot lifecycle::

    FREE --alloc--> ACTIVE --retire(keep_cached=True)--> CACHED --evict/free--> FREE
                       \\---retire(keep_cached=False)-------------------------/

ACTIVE slots are never evicted; ``alloc``/``extend`` fail (return
None/False) rather than touch a live request.  All methods are O(slots)
Python — the pager runs between decode steps, never inside them.
"""
from __future__ import annotations

import dataclasses

FREE, ACTIVE, CACHED = "free", "active", "cached"


def _blocks_for(length: int, block: int) -> int:
    return max(1, -(-int(length) // block))     # ceil, min one page


@dataclasses.dataclass
class _Slot:
    state: str = FREE
    rid: int | None = None
    length: int = 0          # tokens currently charged
    blocks: int = 0          # pages currently charged
    last_use: int = 0        # pager tick of last touch (LRU key)


class KVPager:
    """Slot + block allocator for the fixed-shape decode cache."""

    def __init__(self, n_slots: int, max_len: int, block: int = 16,
                 total_blocks: int | None = None):
        if n_slots < 1 or max_len < 1 or block < 1:
            raise ValueError("n_slots/max_len/block must be >= 1")
        self.n_slots, self.max_len, self.block = n_slots, max_len, block
        self.blocks_per_slot = _blocks_for(max_len, block)
        self.total_blocks = (n_slots * self.blocks_per_slot
                             if total_blocks is None else int(total_blocks))
        if self.total_blocks < self.blocks_per_slot:
            raise ValueError("total_blocks cannot hold even one full slot")
        self.slots = [_Slot() for _ in range(n_slots)]
        self.used_blocks = 0
        self._tick = 0
        self.counters = {"allocs": 0, "evictions": 0, "retires": 0,
                         "frees": 0, "alloc_failures": 0,
                         "peak_blocks": 0, "peak_slots": 0}

    # ---- internals --------------------------------------------------------
    def _touch(self, s: _Slot) -> None:
        self._tick += 1
        s.last_use = self._tick

    def _free_slot_idx(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s.state == FREE:
                return i
        return None

    def _evict_lru(self) -> bool:
        """Reclaim the least-recently-used CACHED slot; False if none."""
        victim = None
        for i, s in enumerate(self.slots):
            if s.state == CACHED and (victim is None or
                                      s.last_use < self.slots[victim].last_use):
                victim = i
        if victim is None:
            return False
        self.free(victim)
        self.counters["evictions"] += 1
        return True

    def _reserve(self, blocks: int) -> bool:
        """Charge ``blocks`` pages, evicting cached slots as needed."""
        while self.used_blocks + blocks > self.total_blocks:
            if not self._evict_lru():
                return False
        self.used_blocks += blocks
        self.counters["peak_blocks"] = max(self.counters["peak_blocks"],
                                           self.used_blocks)
        return True

    # ---- lifecycle --------------------------------------------------------
    def alloc(self, rid: int, length: int) -> int | None:
        """Admit request ``rid`` with an initial cache ``length`` (its
        prompt).  Returns the slot index, or None when no slot/pages can
        be found without touching an active request."""
        if length > self.max_len:
            self.counters["alloc_failures"] += 1
            return None
        idx = self._free_slot_idx()
        if idx is None:
            # no free row: try reclaiming a cached one
            if not self._evict_lru():
                self.counters["alloc_failures"] += 1
                return None
            idx = self._free_slot_idx()
        need = _blocks_for(length, self.block)
        if not self._reserve(need):
            self.counters["alloc_failures"] += 1
            return None
        s = self.slots[idx]
        s.state, s.rid, s.length, s.blocks = ACTIVE, rid, int(length), need
        self._touch(s)
        self.counters["allocs"] += 1
        self.counters["peak_slots"] = max(
            self.counters["peak_slots"],
            sum(1 for t in self.slots if t.state == ACTIVE))
        return idx

    def extend(self, slot: int, new_length: int) -> bool:
        """Grow an active slot to ``new_length`` tokens (decode step),
        charging pages as block boundaries are crossed."""
        s = self.slots[slot]
        if s.state != ACTIVE:
            raise ValueError(f"extend on {s.state} slot {slot}")
        if new_length > self.max_len:
            return False
        need = _blocks_for(new_length, self.block) - s.blocks
        if need > 0 and not self._reserve(need):
            return False
        s.blocks += max(need, 0)
        s.length = max(s.length, int(new_length))
        self._touch(s)
        return True

    def retire(self, slot: int, keep_cached: bool = False) -> None:
        """Explicitly finish a request.  ``keep_cached`` leaves the KV
        resident (LRU-evictable; prefix-reuse hook) instead of freeing."""
        s = self.slots[slot]
        if s.state != ACTIVE:
            raise ValueError(f"retire on {s.state} slot {slot}")
        self.counters["retires"] += 1
        if keep_cached:
            s.state = CACHED
            self._touch(s)
        else:
            self.free(slot)

    def free(self, slot: int) -> None:
        s = self.slots[slot]
        if s.state == FREE:
            return
        self.used_blocks -= s.blocks
        self.counters["frees"] += 1
        self.slots[slot] = _Slot()

    def lookup_cached(self, rid: int) -> int | None:
        """Slot still holding ``rid``'s retired KV, if unevicted."""
        for i, s in enumerate(self.slots):
            if s.state == CACHED and s.rid == rid:
                return i
        return None

    # ---- introspection ----------------------------------------------------
    def slots_in(self, state: str) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.state == state]

    def stats(self) -> dict:
        active = len(self.slots_in(ACTIVE))
        return dict(self.counters,
                    active_slots=active,
                    cached_slots=len(self.slots_in(CACHED)),
                    free_slots=len(self.slots_in(FREE)),
                    used_blocks=self.used_blocks,
                    total_blocks=self.total_blocks,
                    block_utilization=self.used_blocks / self.total_blocks,
                    slot_utilization=active / self.n_slots)

    def check_invariants(self) -> None:
        """Internal consistency (exercised by the hypothesis suite)."""
        charged = sum(s.blocks for s in self.slots if s.state != FREE)
        assert charged == self.used_blocks, (charged, self.used_blocks)
        assert 0 <= self.used_blocks <= self.total_blocks
        rids = [s.rid for s in self.slots if s.state != FREE]
        assert len(rids) == len(set(rids)), "rid occupies two slots"
        for s in self.slots:
            if s.state == FREE:
                assert s.blocks == 0 and s.rid is None
            else:
                assert 1 <= s.blocks <= self.blocks_per_slot
                assert s.blocks == _blocks_for(s.length, self.block)
                assert s.length <= self.max_len
