"""Block-paged pool of packed-F2P KV slabs (port of ``repro.serve.paging``,
DESIGN.md §12).

The pool owns, per attention position ``b<i>`` of ``cfg.pattern`` and per
k/v, one **slab**: a packed QTensor of logical shape ``[G, n_pages,
page_tokens, K, hd]`` (uint32 words ``[G, P, T, K, W]`` plus f32 scales
``[G, P, T, K, 1]``), in the F2P format ``kv_policy`` gives ``kv/b<i>``. A
logical *page* is one index on the page axis, the same index in every
slab, so a request's KV is one ordered page list (:class:`PageTable`) plus
its live length.

The packed layout blocks over head_dim, so every token owns whole words
and a page boundary never splits one: every pool operation is a pure word
copy (``index_select``/``index_copy_`` of uint32 words, through their int32
view, and of f32 scales) with zero repack. The reference donates the slab
buffers to jitted scatter helpers; here the slabs are updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import kv_format


class PoolExhausted(RuntimeError):
    """Raised when an allocation needs more free pages than the pool has."""


@dataclasses.dataclass
class PageTable:
    """One request's view into the pool: ordered page ids + live length."""
    pages: list[int]
    length: int


@dataclasses.dataclass
class HostKV:
    """A request's KV evicted to host memory (numpy), page-granular:
    ``data[b<i>][kv] = (words [G, n, T, K, W] uint32, scales [G, n, T, K,
    1])``."""
    data: dict[str, dict[str, tuple[np.ndarray, np.ndarray]]]
    length: int


def _leaves(qt: QTensor):
    """The two storage leaves of a packed QTensor, words as int32."""
    return qt.codes.view(torch.int32), qt.scales


class PagedKVPool:
    """Fixed-capacity paged store for the packed KV of a model's attention
    layers. Pages move between three homes with bit-exact word copies: a
    slot row of a dense decode cache (``load_into_slot`` /
    ``store_from_slot``), the pool slabs (``store_prefill``, ``relocate``,
    ``compact``), and host memory (``evict_to_host`` /
    ``restore_from_host``). The slabs hold the F2P format that
    ``kv_policy`` sets for ``kv/b0`` (``models.kv_format``)."""

    def __init__(self, cfg: ModelConfig, page_tokens: int, n_pages: int, *,
                 kv_policy=None, device="cuda"):
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.page_tokens = int(page_tokens)
        self.n_pages = int(n_pages)
        self._free = list(range(n_pages))[::-1]   # stack: pop() = lowest
        self.peak_used = 0
        shape = (cfg.n_groups, n_pages, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        self.attn_keys = [f"b{i}" for i in cfg.attn_positions]
        self.slabs: dict[str, dict[str, QTensor]] = {
            f"b{i}": {kv: A.empty_packed(shape, kv_format(kv_policy, i),
                                         self.device) for kv in ("k", "v")}
            for i in cfg.attn_positions}

    # -- allocation --------------------------------------------------------
    def pages_for(self, length: int) -> int:
        return -(-int(length) // self.page_tokens)

    @property
    def used(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)}/{self.n_pages} free")
        pages = [self._free.pop() for _ in range(n)]
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages or p in self._free:
                raise ValueError(f"bad free of page {p}")
        self._free.extend(sorted(pages, reverse=True))

    def extend(self, table: PageTable, n: int) -> list[int]:
        """Grow a live table by ``n`` fresh pages (lazy decode growth)."""
        new = self.alloc(n)
        table.pages.extend(new)
        return new

    def trim(self, table: PageTable, length: int) -> None:
        """Shrink a table to the pages covering ``length`` tokens, freeing
        look-ahead growth pages, and record the live length."""
        keep = self.pages_for(length)
        if keep < len(table.pages):
            self.free(table.pages[keep:])
            del table.pages[keep:]
        table.length = int(length)

    # -- page <-> slab movement -------------------------------------------
    def _idx(self, pages) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.int64, device=self.device)

    def _each_leaf(self):
        """(position key, k/v) of every slab."""
        for key in self.attn_keys:
            for kv in ("k", "v"):
                yield key, kv

    def _store_row(self, caches, length: int, row: int) -> PageTable:
        n = self.pages_for(length)
        pages = self.alloc(n)
        idx = self._idx(pages)
        T = self.page_tokens
        for key, kv in self._each_leaf():
            c = caches[key][kv]
            if not isinstance(c, QTensor):
                raise TypeError(f"cache {key}/{kv} must be a packed QTensor")
            for slab, leaf in zip(_leaves(self.slabs[key][kv]), _leaves(c)):
                blk = leaf[:, row, :n * T]
                slab.index_copy_(1, idx, blk.reshape(
                    (blk.shape[0], n, T) + tuple(blk.shape[2:])))
        return PageTable(pages=pages, length=int(length))

    def store_prefill(self, caches, length: int, row: int = 0) -> PageTable:
        """Copy row ``row`` of a prefill cache into fresh pages (the cache's
        token axis covers ceil(length / page_tokens) whole pages)."""
        return self._store_row(caches, length, row)

    def store_from_slot(self, caches, slot: int, length: int) -> PageTable:
        """Page out a live decode-cache slot (preemption)."""
        return self._store_row(caches, length, slot)

    def load_into_slot(self, table: PageTable, caches, slot: int):
        """Copy a page table's KV into row ``slot`` of the dense decode
        caches, in place; returns ``caches``."""
        idx = self._idx(table.pages)
        n = len(table.pages) * self.page_tokens
        for key, kv in self._each_leaf():
            for slab, leaf in zip(_leaves(self.slabs[key][kv]),
                                  _leaves(caches[key][kv])):
                blk = slab.index_select(1, idx)
                leaf[:, slot, :n].copy_(blk.reshape(
                    (blk.shape[0], n) + tuple(blk.shape[3:])))
        return caches

    def _move_pages(self, src: list[int], dst: list[int]) -> None:
        """Pages src -> dst in every slab leaf (the gather copies before
        the scatter writes, so overlapping moves are safe)."""
        s, d = self._idx(src), self._idx(dst)
        for key, kv in self._each_leaf():
            for slab in _leaves(self.slabs[key][kv]):
                slab.index_copy_(1, d, slab.index_select(1, s))

    def relocate(self, table: PageTable) -> PageTable:
        """Move a request's pages to fresh slots: a whole-word copy."""
        new = self.alloc(len(table.pages))
        self._move_pages(table.pages, new)
        self.free(table.pages)
        return PageTable(pages=new, length=table.length)

    def compact(self, tables: list[PageTable]) -> None:
        """Defragment: repack every live page into the lowest slots, in
        table order, updating the tables in place."""
        src, dst = [], []
        nxt = 0
        for t in tables:
            newpages = []
            for p in t.pages:
                if p != nxt:
                    src.append(p)
                    dst.append(nxt)
                newpages.append(nxt)
                nxt += 1
            t.pages = newpages
        if src:
            self._move_pages(src, dst)
        self._free = list(range(nxt, self.n_pages))[::-1]

    # -- host eviction -----------------------------------------------------
    def evict_to_host(self, table: PageTable) -> HostKV:
        """Pull a page table's contents to host numpy and free its pages."""
        idx = self._idx(table.pages)
        data: dict[str, dict[str, tuple[np.ndarray, np.ndarray]]] = {}
        for key, kv in self._each_leaf():
            w, s = _leaves(self.slabs[key][kv])
            data.setdefault(key, {})[kv] = (
                w.index_select(1, idx).cpu().numpy().view(np.uint32),
                s.index_select(1, idx).cpu().numpy())
        self.free(table.pages)
        return HostKV(data=data, length=table.length)

    def restore_from_host(self, host: HostKV) -> PageTable:
        """Upload host-evicted KV into fresh pages."""
        pages = self.alloc(self.pages_for(host.length))
        idx = self._idx(pages)
        for key, kv in self._each_leaf():
            w, s = _leaves(self.slabs[key][kv])
            hw, hs = host.data[key][kv]
            w.index_copy_(1, idx, torch.from_numpy(hw.view(np.int32)).to(
                self.device))
            s.index_copy_(1, idx, torch.from_numpy(hs).to(self.device))
        return PageTable(pages=pages, length=host.length)

    # -- accounting --------------------------------------------------------
    def occupancy(self) -> float:
        return self.used / self.n_pages

    def _slab_list(self) -> list[QTensor]:
        return [self.slabs[key][kv] for key, kv in self._each_leaf()]

    def page_bytes_packed(self) -> int:
        """Packed bytes of ONE logical page across every slab (the sum over
        the attention positions, each at its own format)."""
        return self.pool_bytes_packed() // self.n_pages

    def pool_bytes_packed(self) -> int:
        return sum(s.nbytes for s in self._slab_list())

    def pool_bytes_live_packed(self) -> int:
        return self.used * self.page_bytes_packed()

    def pool_bytes_logical_f32(self) -> int:
        return sum(int(np.prod(s.shape)) * 4 for s in self._slab_list())

    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "used": self.used,
            "peak_used": self.peak_used,
            "occupancy": self.occupancy(),
            "page_tokens": self.page_tokens,
            "page_bytes_packed": self.page_bytes_packed(),
            "pool_bytes_packed": self.pool_bytes_packed(),
            "pool_bytes_live_packed": self.pool_bytes_live_packed(),
            "pool_bytes_logical_f32": self.pool_bytes_logical_f32(),
        }
