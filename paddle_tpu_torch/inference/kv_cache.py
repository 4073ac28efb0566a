"""Block-allocated paged KV cache: the port of ``paddle_tpu/inference/
kv_cache.py``.

- :class:`BlockAllocator` — host-side free list over ``num_blocks`` block
  ids, all-or-nothing ``alloc``, lowest-id-first hand-out, lifetime
  accounting.
- :class:`PagedLayerCache` — what one decoder layer sees in a step: the
  ``(num_slots + 1, heads, head_dim)`` key and value pages plus the batch's
  int32 ``block_tables`` / ``seq_lens`` / ``slot_mapping`` on the device.
- :class:`PagedKVCache` — per-layer pages, the allocator and the
  per-sequence tables, with the helpers that build a step's inputs.

Slots: block ``b`` owns flat rows ``[b*block_size, (b+1)*block_size)``;
``slot = table[pos // bs] * bs + pos % bs``.  ``slot_pad == num_slots``
names the trailing row of the pages: pad positions write there and no read
ever touches it.

``defrag`` compacts the live blocks to the lowest ids and permutes the
pages to match, out of place (``index_select`` into new tensors, one layer
at a time: source and destination slots overlap, so an in-place copy from
the same tensor would read rows it already overwrote).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..framework.errors import enforce

__all__ = ["KV_BLOCK_SIZE_ENV", "default_kv_block_size", "BlockAllocator",
           "PagedLayerCache", "PagedKVCache"]

KV_BLOCK_SIZE_ENV = "PTPU_KV_BLOCK_SIZE"


def default_kv_block_size() -> int:
    return int(os.environ.get(KV_BLOCK_SIZE_ENV, "16"))


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.

    ``alloc`` is all-or-nothing: a request the pool cannot satisfy takes
    nothing (the scheduler preempts and retries instead of holding partial
    grants).  Blocks are handed out lowest id first.
    """

    def __init__(self, num_blocks: int, block_size: int):
        enforce(num_blocks > 0 and block_size > 0,
                f"bad pool shape: {num_blocks} blocks x {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._live: set = set()
        self.total_allocs = 0
        self.total_frees = 0
        self.high_water = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def occupancy(self) -> float:
        return self.num_used / self.num_blocks

    def blocks_for_tokens(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache entries."""
        return -(-max(0, int(num_tokens)) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks, or None (taking nothing) when the pool cannot
        satisfy the whole request."""
        if n < 0 or len(self._free) < n:
            return None
        got = [self._free.pop() for _ in range(n)]
        self._live.update(got)
        self.total_allocs += len(got)
        self.high_water = max(self.high_water, self.num_used)
        return got

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            enforce(b in self._live, f"double/foreign free of block {b}")
            self._live.discard(b)
            self._free.append(b)
        self.total_frees += len(blocks)
        self._free.sort(reverse=True)     # keep lowest-id-first hand-out

    def stats(self) -> Dict[str, object]:
        """Lifetime accounting; ``balanced`` is the leak-freedom invariant
        (allocs minus frees equals live)."""
        return {"num_blocks": self.num_blocks,
                "num_used": self.num_used,
                "num_free": self.num_free,
                "total_allocs": self.total_allocs,
                "total_frees": self.total_frees,
                "high_water": self.high_water,
                "balanced": (self.total_allocs - self.total_frees
                             == self.num_used)}

    def defrag(self, tables: Dict[object, List[int]]
               ) -> Optional[np.ndarray]:
        """Compact live blocks to ids ``[0, num_used)``.

        ``tables`` maps owner -> block-id list covering every live block;
        tables are renumbered in place.  Returns ``perm`` with
        ``perm[new_id] = old_id`` (length ``num_blocks``) for permuting the
        pages, or None when already compact (no device traffic needed).
        With fixed-size blocks there is no external fragmentation: defrag
        re-densifies the pool after churn, so the used prefix stays small.
        """
        live = sorted(self._live)
        referenced = sorted({b for t in tables.values() for b in t})
        enforce(referenced == live,
                f"defrag: tables cover {referenced} but live={live}")
        if live == list(range(len(live))):
            return None
        mapping = {old: new for new, old in enumerate(live)}
        for t in tables.values():
            t[:] = [mapping[b] for b in t]
        spare = [b for b in range(self.num_blocks) if b not in mapping]
        perm = np.empty(self.num_blocks, np.int64)
        for old, new in mapping.items():
            perm[new] = old
        perm[len(live):] = spare
        self._live = set(range(len(live)))
        self._free = list(range(self.num_blocks - 1, len(live) - 1, -1))
        return perm


@dataclasses.dataclass
class PagedLayerCache:
    """One decoder layer's paged-cache view for one step.

    ``k_pages`` / ``v_pages``: ``(num_slots + 1, heads, head_dim)``; the
    last row is the pad sentinel.  ``block_tables``: ``(batch,
    max_blocks)`` int32 (unused entries 0, masked by ``seq_lens``).
    ``seq_lens``: ``(batch,)`` int32 context length including this step's
    tokens (0 = padding row).  ``slot_mapping``: ``(batch, chunk)`` int32
    write slot per new token, ``num_slots`` for padding.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    seq_lens: torch.Tensor
    slot_mapping: torch.Tensor
    block_size: int


class PagedKVCache:
    """Whole-model paged KV store: per-layer pages on ``device`` (``cuda``
    when none is given; the CPU only when asked), the allocator and the
    per-sequence block tables."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = (default_kv_block_size() if block_size is None
                           else int(block_size))
        self.num_blocks = int(num_blocks)
        self.num_slots = self.num_blocks * self.block_size
        self.slot_pad = self.num_slots        # the trailing sentinel row
        self.dtype = dtype
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(self.num_blocks, self.block_size)
        self._tables: Dict[object, List[int]] = {}
        shape = (self.num_slots + 1, self.num_heads, self.head_dim)
        self.pages = [(torch.zeros(shape, dtype=dtype, device=self.device),
                       torch.zeros(shape, dtype=dtype, device=self.device))
                      for _ in range(self.num_layers)]

    # -- per-sequence table management ------------------------------------
    def table(self, seq_id) -> List[int]:
        return self._tables.get(seq_id, [])

    def live_seqs(self) -> List[object]:
        return list(self._tables)

    def ensure_capacity(self, seq_id, num_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``num_tokens`` cache slots;
        False (nothing taken) when the pool cannot supply the growth."""
        table = self._tables.setdefault(seq_id, [])
        need = self.allocator.blocks_for_tokens(num_tokens) - len(table)
        if need <= 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            if not table:
                del self._tables[seq_id]
            return False
        table.extend(got)
        return True

    def free_seq(self, seq_id) -> None:
        table = self._tables.pop(seq_id, None)
        if table:
            self.allocator.free(table)

    def slot(self, seq_id, pos: int) -> int:
        """Flat page slot of cache position ``pos`` for ``seq_id``."""
        table = self._tables[seq_id]
        block = pos // self.block_size
        enforce(0 <= block < len(table),
                f"pos {pos} outside {seq_id}'s {len(table)}-block table")
        return table[block] * self.block_size + pos % self.block_size

    def occupancy(self) -> float:
        return self.allocator.occupancy()

    def leak_report(self) -> Dict[str, object]:
        """Allocator lifetime counters plus the table-coverage check: a
        nonzero ``leaked_blocks`` means blocks marked used that no table
        covers."""
        report = self.allocator.stats()
        tabled = sum(len(t) for t in self._tables.values())
        report["live_seqs"] = len(self._tables)
        report["tabled_blocks"] = tabled
        report["leaked_blocks"] = int(report["num_used"]) - tabled
        return report

    # -- step inputs --------------------------------------------------------
    def table_array(self, seq_ids: Sequence[object],
                    max_blocks: int) -> np.ndarray:
        """``(len(seq_ids), max_blocks)`` int32 block tables; absent or
        short tables are 0-padded (masked by seq_lens)."""
        out = np.zeros((len(seq_ids), max_blocks), np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables.get(sid, [])
            enforce(len(t) <= max_blocks,
                    f"{sid}: {len(t)} blocks > table width {max_blocks}")
            out[i, :len(t)] = t
        return out

    def slot_array(self, seq_ids: Sequence[object],
                   starts: Sequence[int], chunk: int) -> np.ndarray:
        """``(len(seq_ids), chunk)`` write slots for positions
        ``starts[i] .. starts[i]+chunk-1``; positions past a table (and
        padding rows, ``start < 0``) get the pad sentinel."""
        out = np.full((len(seq_ids), chunk), self.slot_pad, np.int32)
        for i, (sid, start) in enumerate(zip(seq_ids, starts)):
            if start < 0:
                continue
            table = self._tables.get(sid, [])
            cap = len(table) * self.block_size
            for j in range(chunk):
                pos = start + j
                if pos < cap:
                    out[i, j] = (table[pos // self.block_size]
                                 * self.block_size + pos % self.block_size)
        return out

    def layer_caches(self, block_tables: np.ndarray, seq_lens: np.ndarray,
                     slot_mapping: np.ndarray) -> List[PagedLayerCache]:
        """One :class:`PagedLayerCache` per layer over the live pages; the
        three index arrays go to the device once and are shared."""
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.int32)).to(self.device)
        bt, sl, sm = as_dev(block_tables), as_dev(seq_lens), \
            as_dev(slot_mapping)
        return [PagedLayerCache(k, v, bt, sl, sm, self.block_size)
                for (k, v) in self.pages]

    # -- defrag ------------------------------------------------------------
    def defrag(self) -> bool:
        """Compact the pool (see :meth:`BlockAllocator.defrag`) and permute
        the pages to match; True when a permutation was applied.  Each
        layer's pages are gathered into new tensors (the JAX package's
        ``jnp.take``), replacing that layer before the next is gathered,
        so the copy needs one layer's pages of extra memory.  The sentinel
        row stays last.  Work stays on the current stream, behind every
        step already queued there."""
        perm = self.allocator.defrag(self._tables)
        if perm is None:
            return False
        slot_perm = (perm[:, None] * self.block_size
                     + np.arange(self.block_size)[None, :]).reshape(-1)
        slot_perm = np.concatenate([slot_perm, [self.num_slots]])
        idx = torch.as_tensor(slot_perm).to(self.device)
        for i, (k, v) in enumerate(self.pages):
            self.pages[i] = (k.index_select(0, idx), v.index_select(0, idx))
        return True
