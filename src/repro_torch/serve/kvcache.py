"""KV cache backends: per-slot dense caches, and paged pools with block
tables, refcounted pages and a prefix index.

A copy of the JAX package's ``serve/kvcache.py`` (which imports JAX, so the
port keeps its own).  The dense backend keeps one ``(slots, cache_len)``
cache per layer and splices a bucketed prefill's rows into a slot at
admission (``splice_row`` along the slot axis ``slot_axes`` finds).  The
paged backend keeps KV in fixed-size *pages* of a shared pool per layer;
per-slot *block tables* map logical block -> physical page.  Pages are
refcounted: the chunked engine shares common prompt prefixes across
slots through a radix ``PrefixIndex`` over page-granular token runs, and
a prompt diverging mid-page copies the divergence page once
(copy-on-write) before overwriting its tail.  Shared pages are read-only
by invariant: the engine only writes rows at positions >= its prefill
offset, which land in freshly allocated (or copied) pages.

The host-side parts (``PageSpec``, ``BlockAllocator``, ``PrefixIndex``, the
block tables) are plain Python and numpy exactly as in the JAX package, so
a run of both engines on one trace hands out the same pages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.troop import sublane
from repro_torch.quant.tensor import quantize_kv
from repro_torch.serve.config import resolve_page_size

NULL_PAGE = 0          # page 0 is never allocated: idle slots point here


class ChunkStage(NamedTuple):
    """bf16 staging rows for the one in-flight chunked-prefill slot.

    Only allocated when the page pools are int8: chunk c of a prompt
    attends over the KV of chunks < c, and reading those rows back through
    the int8 pages would make chunked prefill diverge from the bucketed
    engine (which runs the whole prompt in bf16 and quantizes only at
    storage).  The stage keeps the current request's own prefill rows at
    bf16, ``(1, S, KV, hd)``, while the int8 pages written alongside stay
    the decode-time source of truth."""
    k: torch.Tensor
    v: torch.Tensor


class PagedKVCache(NamedTuple):
    """Paged KV leaf of one attention layer: page pools (P, page, KV, hd),
    indexed by a per-slot block table that is per-step input
    (``batch["block_tables"]``) — one table addresses every layer's pool.

    int8 pools carry *scale pages* beside them: per-(token, head) bf16
    absmax scales (P, page, KV, 1) addressed by the same block table, and
    the layer's ``ChunkStage`` when the chunked engine runs over them (the
    JAX package keeps the stage next to the leaf in the layer's cache
    entry; here it rides in the leaf)."""
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    k_scale_pool: Optional[torch.Tensor] = None
    v_scale_pool: Optional[torch.Tensor] = None
    stage: Optional[ChunkStage] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale_pool is not None


@dataclass(frozen=True)
class PageSpec:
    """Static paging geometry for one engine."""
    page_size: int            # tokens per page (a layout granule multiple)
    num_pages: int            # physical pages per layer pool (incl. null)
    blocks_per_slot: int      # logical blocks per slot (= ceil(S / page))
    kv_dtype: str = "bfloat16"  # page-pool storage

    def validate(self):
        g = sublane(self.kv_dtype)
        assert self.page_size % g == 0, \
            f"page_size {self.page_size} not a multiple of the " \
            f"{g}-row layout granule for {self.kv_dtype} (mechanism D)"
        assert self.num_pages > NULL_PAGE + 1
        return self

    @staticmethod
    def for_engine(slots: int, cache_len: int, page_size: int,
                   num_pages: Optional[int] = None,
                   dtype="bfloat16") -> "PageSpec":
        blocks = -(-cache_len // page_size)
        pages = num_pages if num_pages is not None else slots * blocks + 1
        name = str(dtype).replace("torch.", "")
        return PageSpec(page_size, pages, blocks, name).validate()


class BlockAllocator:
    """Host-side refcounted free list over physical pages [1, num_pages).

    ``alloc`` hands out pages at refcount 1; ``incref`` adds holders
    (another slot sharing the page, or the prefix index keeping it warm);
    ``free`` decrefs and returns a page to the free list only when its last
    holder lets go."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def ref(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, pages: List[int]):
        for p in pages:
            assert self._refs.get(p, 0) > 0, f"incref of unheld page {p}"
            self._refs[p] += 1

    def free(self, pages: List[int]):
        for p in pages:
            assert p != NULL_PAGE
            n = self._refs.get(p, 0)
            assert n > 0, f"double free of page {p}"
            if n == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = n - 1


class _PrefixNode:
    """One cached page: ``tokens`` (page_size-tuple) -> physical ``page``."""

    __slots__ = ("tokens", "page", "children", "last_used")

    def __init__(self, tokens, page):
        self.tokens = tokens
        self.page = page
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.last_used = 0


class PrefixIndex:
    """Radix tree over page-granular token prefixes -> physical pages.

    Each node is one full page of prompt tokens; a path from the root spells
    a prompt prefix and yields the refcounted pages holding its KV.  The
    index holds one reference on every cached page (taken at ``insert``,
    dropped at eviction), so pages survive their originating request and
    are evicted LRU-leaf-first only under pool pressure."""

    def __init__(self, page_size: int, allocator: BlockAllocator):
        self.page_size = page_size
        self.allocator = allocator
        self.root = _PrefixNode((), NULL_PAGE)
        self._clock = 0
        self._nodes = 0
        self.hits = 0
        self.lookups = 0
        self.evictions = 0

    @property
    def num_pages(self) -> int:
        return self._nodes

    def _pages(self, prompt) -> List[tuple]:
        ps = self.page_size
        toks = [int(t) for t in prompt]
        return [tuple(toks[i:i + ps]) for i in range(0, len(toks) - ps + 1,
                                                     ps)]

    def match(self, prompt):
        """Longest cached prefix of ``prompt``: (pages, partial).

        ``pages``: physical pages of fully matched leading pages (not yet
        incref'd).  ``partial``: ``(page, depth)`` when the first unmatched
        page shares its leading ``depth`` tokens with a cached page — the
        copy-on-write candidate — else ``None``.  The match leaves at least
        the prompt's final token to compute."""
        self.lookups += 1
        self._clock += 1
        ps = self.page_size
        limit = len(prompt) - 1            # tokens allowed to come from cache
        node, pages, depth = self.root, [], 0
        for key in self._pages(prompt):
            if depth + ps > limit:
                break
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node, depth = child, depth + ps
        partial = None
        rest = [int(t) for t in prompt[depth:limit]]
        if rest:
            best = 0
            for key, child in node.children.items():
                j = 0
                while j < len(rest) and j < ps and key[j] == rest[j]:
                    j += 1
                if j > best:
                    best, partial = j, (child.page, j)
                    child.last_used = self._clock
        if pages or partial:
            self.hits += 1
        return pages, partial

    def insert(self, prompt, pages: List[int]):
        """Register ``prompt``'s leading full pages; the index increfs each
        page it newly adopts."""
        self._clock += 1
        node = self.root
        for key, page in zip(self._pages(prompt), pages):
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, page)
                node.children[key] = child
                self.allocator.incref([page])
                self._nodes += 1
            child.last_used = self._clock
            node = child

    def evict(self, need: int) -> int:
        """Drop LRU leaf pages held only by the index until ``need`` pages
        have been freed or nothing more is evictable."""
        freed = 0
        while freed < need:
            victims = []                  # (last_used, parent, key, node)
            stack = [self.root]
            while stack:
                node = stack.pop()
                for key, child in node.children.items():
                    if not child.children \
                            and self.allocator.ref(child.page) == 1:
                        victims.append((child.last_used, node, key, child))
                    stack.append(child)
            if not victims:
                break
            victims.sort(key=lambda v: v[0])
            for _, parent, key, child in victims[:need - freed]:
                del parent.children[key]
                self.allocator.free([child.page])
                self._nodes -= 1
                self.evictions += 1
                freed += 1
        return freed

    def clear(self):
        """Drop every index-held reference (leaves first, repeatedly)."""
        while self._nodes and self.evict(self._nodes):
            pass


# --------------------------------------------------------------------------
# Splicing helpers (shared by both backends)
# --------------------------------------------------------------------------
def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree (lists and NamedTuples of tensors, their
    ``None`` fields skipped), in one fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for sub in tree for t in _tensors(sub)]


def _batch_dim(dst_shape, src_shape, slots):
    """Batch dim for a B=1 splice: where dst == slots and src == 1 (prefer
    dim 1: stacked layer caches are (layers, B, ...))."""
    for d in (1, 0):
        if len(dst_shape) > d and dst_shape[d] == slots \
                and src_shape[d] == 1:
            return d
    raise ValueError(f"cannot locate batch dim: {tuple(dst_shape)} vs "
                     f"{tuple(src_shape)}")


def splice_row(dst, src, row: int, slot: int, slots: int,
               axis: Optional[int] = None):
    """Write row ``row`` of a batched prefill array into slot ``slot`` of a
    batch-cache array, in place, zero-padding the trailing (sequence) dims
    up to dst's size; returns ``dst``.

    ``axis`` is the leaf's slot axis (from ``slot_axes``: exact, no shape
    guessing); without it, the B=1 heuristic ``_batch_dim``.  ``axis`` -1
    marks a slot-independent leaf (a shared page pool): left alone."""
    bi = _batch_dim(dst.shape, src.shape, slots) if axis is None else axis
    if bi < 0:
        return dst
    src = src.narrow(bi, row, 1)
    target = dst.narrow(bi, slot, 1)
    target.zero_()
    target[tuple(slice(0, n) for n in src.shape)].copy_(src)
    return dst


def slot_axes(model, slots: int, cache_len: int, page_spec=None,
              chunk_stage: int = 0) -> List[tuple]:
    """Per-layer slot axes of the cache tree, derived structurally: the
    caches ``init_caches`` builds at ``slots`` and at ``slots + 1`` on the
    ``meta`` device (nothing is allocated; JAX's ``eval_shape``), diffed
    tensor by tensor — the axis whose extent changes is the slot axis (-1:
    slot-independent, e.g. a shared page pool).  Entry i holds one axis
    for each tensor of layer i's cache (``_tensors`` order), so a head or
    sequence extent that happens to equal ``slots`` is never taken for
    it."""
    meta = torch.device("meta")
    a, b = (model.init_caches(n, cache_len, page_spec=page_spec,
                              chunk_stage=chunk_stage, device=meta)
            for n in (slots, slots + 1))

    def axis(x, y):
        return next((d for d, (p, q) in enumerate(zip(x.shape, y.shape))
                     if p != q), -1)

    return [tuple(axis(x, y) for x, y in zip(_tensors(la), _tensors(lb)))
            for la, lb in zip(a, b)]


def _pool_scatter(pool, rows, pages: torch.Tensor):
    """Write prefill KV rows into the pages ``pages`` (a device index
    tensor) of one pool, in place.  pool: (P, page, KV, hd); rows:
    (T, KV, hd), zero-padded or truncated to exactly fill the pages."""
    page = pool.shape[1]
    need = pages.shape[0] * page
    T = rows.shape[0]
    if T < need:
        rows = torch.cat([rows, rows.new_zeros((need - T,) + rows.shape[1:])])
    else:
        rows = rows[:need]
    buf = rows.reshape((pages.shape[0], page) + rows.shape[1:])
    pool.index_copy_(0, pages, buf.to(pool.dtype))
    return pool


def copy_page(caches, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` in every layer's pools, in
    place (the copy-on-write at a mid-page prefix divergence); the scale
    pages of int8 pools ride along, so a copied page keeps its value and
    scale rows coherent."""
    for c in caches:
        for pool in (c.k_pool, c.v_pool, c.k_scale_pool, c.v_scale_pool):
            if pool is not None:
                pool[dst].copy_(pool[src])
    return caches


def kv_row_bytes(cfg, kv_dtype: str) -> int:
    """Bytes one token-row of KV occupies across all attention layers;
    ``int8`` rows carry their per-(token, head) bf16 scales."""
    n_attn = sum(1 for (m, _) in cfg.layer_kinds() if m == "attn")
    if kv_dtype == "int8":
        per_layer = cfg.num_kv_heads * cfg.head_dim * 2      # K + V bytes
        per_layer += cfg.num_kv_heads * 2 * 2                # bf16 scales
    else:
        itemsize = torch.empty((), dtype=getattr(torch, kv_dtype)) \
            .element_size()
        per_layer = cfg.num_kv_heads * cfg.head_dim * itemsize * 2
    return n_attn * per_layer


class DenseBackend:
    """Per-slot dense caches of capacity ``cache_len`` (the JAX package's
    default layout): a bucketed prefill's rows are spliced into the
    admitted slot, and every slot always holds its whole capacity."""

    name = "dense"

    def __init__(self):
        self.slots = 0
        self.cache_len = 0

    def init_caches(self, model, slots: int, cache_len: int):
        self.slots = slots
        self.cache_len = cache_len
        self._axes = slot_axes(model, slots, cache_len)
        return model.init_caches(slots, cache_len)

    def check_admissible(self, tokens: int):
        pass

    def reserve(self, slot: int, tokens: int) -> bool:
        return True

    def admit(self, caches, prefill_caches, *, row: int, slot: int,
              prompt_len: int):
        """Row ``row`` of the batched prefill caches into slot ``slot``, in
        place (the rows past the prompt, pad tokens', too: decode's
        ``length = pos + 1`` masks them)."""
        for dst, src, axes in zip(caches, prefill_caches, self._axes):
            for d, s, ax in zip(_tensors(dst), _tensors(src), axes):
                splice_row(d, s, row, slot, self.slots, axis=ax)
        return caches

    def release(self, slot: int):
        pass

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name,
                "cache_tokens": self.slots * self.cache_len}


class PagedBackend:
    """Page pool + block tables; pages are layout granules.

    ``num_pages=None`` sizes the pool for full occupancy; smaller values
    overcommit device memory — admission then *defers* when the pool is
    exhausted instead of running out of memory.

    ``kv_dtype="int8"`` stores pages quantized (per-(token, head) absmax
    scales in sibling scale pages — same block table, same allocator);
    left ``None`` it follows the model's ``RuntimeConfig``.  int8 pages
    are multiples of the 32-row granule.  ``chunk_stage`` (set by the
    engine): its chunk size, which sizes the bf16 ``ChunkStage`` over int8
    pools (0: no staging buffer)."""

    name = "paged"

    def __init__(self, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False):
        self.page_size = page_size
        self.num_pages = num_pages
        self.kv_dtype = kv_dtype       # resolved by init_caches
        self.prefix_cache = prefix_cache
        self.chunk_stage = 0
        self.spec: Optional[PageSpec] = None
        self.prefix_index: Optional[PrefixIndex] = None
        self._pending_cow: Dict[int, Any] = {}
        self._shared_tokens = 0
        self.cow_copies = 0

    def init_caches(self, model, slots: int, cache_len: int):
        # the KV storage name sets the page granule; bf16-named pools take
        # the model's compute dtype, as in the JAX package
        dtype = self.kv_dtype or model.rt.kv_dtype()
        self.kv_dtype = dtype
        self.slots = slots
        self.cache_len = cache_len
        self.spec = PageSpec.for_engine(slots, cache_len, self.page_size,
                                        self.num_pages, dtype)
        self.allocator = BlockAllocator(self.spec.num_pages)
        self.block_tables = np.full(
            (slots, self.spec.blocks_per_slot), NULL_PAGE, np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        if self.prefix_cache:
            self.prefix_index = PrefixIndex(self.spec.page_size,
                                            self.allocator)
        self._axes = slot_axes(model, slots, cache_len, page_spec=self.spec,
                               chunk_stage=self.chunk_stage)
        self._row_bytes = kv_row_bytes(model.cfg, dtype)
        return model.init_caches(slots, cache_len, page_spec=self.spec,
                                 chunk_stage=self.chunk_stage)

    def _pages_needed(self, tokens: int) -> int:
        return -(-min(tokens, self.cache_len) // self.spec.page_size)

    def check_admissible(self, tokens: int):
        """Raised at submit time, before anything is reserved."""
        need = self._pages_needed(tokens)
        if need > self.spec.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool holds "
                f"{self.spec.num_pages - 1}: it can never be admitted — "
                f"raise num_pages or lower prompt_len + max_new_tokens")

    def _alloc_evicting(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting cold prefix-index pages to make
        room (pages held by live slots are never evicted)."""
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix_index is not None:
            self.prefix_index.evict(n - self.allocator.num_free)
            pages = self.allocator.alloc(n)
        return pages

    def reserve(self, slot: int, tokens: int) -> bool:
        pages = self._alloc_evicting(self._pages_needed(tokens))
        if pages is None:
            return False
        self._slot_pages[slot] = pages
        self.block_tables[slot] = NULL_PAGE
        self.block_tables[slot, :len(pages)] = pages
        return True

    def reserve_with_prefix(self, slot: int, tokens: int,
                            prompt) -> Optional[int]:
        """Reserve ``slot`` reusing cached prefix pages of ``prompt``.

        Returns the number of prompt tokens whose KV comes from the cache
        (the chunked engine starts prefilling at that offset), or ``None``
        when the pool is exhausted (admission defers).  A mid-page partial
        match registers a pending copy-on-write the engine applies
        (``take_cow`` / ``cow_done``) before writing the slot's pages."""
        if self.prefix_index is None:
            return 0 if self.reserve(slot, tokens) else None
        page = self.spec.page_size
        shared, partial = self.prefix_index.match(prompt)
        # take the slot's references before any eviction can run
        self.allocator.incref(shared)
        cow_src, cow_depth = partial if partial else (None, 0)
        if cow_src is not None:
            self.allocator.incref([cow_src])
        fresh_n = self._pages_needed(tokens) - len(shared)
        fresh = self._alloc_evicting(fresh_n)
        if fresh is None:                       # pool pressure: undo, defer
            self.allocator.free(shared)
            if cow_src is not None:
                self.allocator.free([cow_src])
            return None
        if cow_src is not None:
            self._pending_cow[slot] = (cow_src, fresh[0])
        pages = shared + fresh
        self._slot_pages[slot] = pages
        self.block_tables[slot] = NULL_PAGE
        self.block_tables[slot, :len(pages)] = pages
        offset = len(shared) * page + cow_depth
        self._shared_tokens += offset
        return offset

    def take_cow(self, slot: int):
        """Pending (src_page, dst_page) copy for ``slot``, or ``None``."""
        return self._pending_cow.get(slot)

    def cow_done(self, slot: int):
        """The engine copied the divergence page: drop the source ref."""
        src, _ = self._pending_cow.pop(slot)
        self.allocator.free([src])
        self.cow_copies += 1

    def register_prefix(self, slot: int, prompt):
        """Index ``slot``'s fully written prompt pages for future reuse."""
        if self.prefix_index is None:
            return
        full = len(prompt) // self.spec.page_size
        if full:
            self.prefix_index.insert(prompt, self._slot_pages[slot][:full])

    def admit(self, caches, prefill_caches, *, row: int, slot: int,
              prompt_len: int):
        """Row ``row`` of the batched (dense) prefill caches into ``slot``'s
        first ``ceil(prompt_len / page)`` pages, in place.  An int8 pool
        takes an int8 prefill cache's codes and scales verbatim (so paged
        and dense int8 engines hold the same rows) and quantizes a bf16
        prefill cache here; a layer whose cache is not paged takes the
        dense splice along its slot axis."""
        n_prefill = -(-prompt_len // self.spec.page_size)
        pages = None
        for dst, src, axes in zip(caches, prefill_caches, self._axes):
            if not isinstance(dst, PagedKVCache):
                for d, s, ax in zip(_tensors(dst), _tensors(src), axes):
                    splice_row(d, s, row, slot, self.slots, axis=ax)
                continue
            if pages is None:
                pages = torch.tensor(self._slot_pages[slot][:n_prefill],
                                     dtype=torch.long,
                                     device=dst.k_pool.device)
            k, v = src.k[row], src.v[row]
            if not dst.quantized:
                _pool_scatter(dst.k_pool, k, pages)
                _pool_scatter(dst.v_pool, v, pages)
                continue
            if getattr(src, "quantized", False):
                (k8, ks), (v8, vs) = ((k, src.k_scale[row]),
                                      (v, src.v_scale[row]))
            else:
                (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            for pool, rows in ((dst.k_pool, k8), (dst.v_pool, v8),
                               (dst.k_scale_pool, ks),
                               (dst.v_scale_pool, vs)):
                _pool_scatter(pool, rows, pages)
        return caches

    def release(self, slot: int):
        if slot in self._pending_cow:           # released before the copy
            src, _ = self._pending_cow.pop(slot)
            self.allocator.free([src])
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.allocator.free(pages)
        self.block_tables[slot] = NULL_PAGE

    def kv_page_bytes(self) -> Dict[str, int]:
        """Logical (every block-table entry) vs resident (each physical
        page once) KV pages and bytes."""
        sp = self.spec
        if sp is None:
            return {"kv_pages_logical": 0, "kv_pages_resident": 0}
        live = self.block_tables[self.block_tables != NULL_PAGE]
        page_bytes = sp.page_size * self._row_bytes
        resident = int(np.unique(live).size)
        return {"kv_pages_logical": int(live.size),
                "kv_pages_resident": resident,
                "kv_page_bytes_logical": int(live.size) * page_bytes,
                "kv_page_bytes_resident": resident * page_bytes}

    def stats(self) -> Dict[str, Any]:
        sp = self.spec
        out = {
            "backend": self.name,
            "page_size": sp.page_size if sp else self.page_size,
            "num_pages": sp.num_pages if sp else self.num_pages,
            "kv_dtype": sp.kv_dtype if sp else self.kv_dtype,
            "pages_free": self.allocator.num_free if sp else None,
            "pages_in_use": (sp.num_pages - 1 - self.allocator.num_free)
            if sp else None,
        }
        out.update(self.kv_page_bytes())
        if self.prefix_index is not None:
            out.update({
                "prefix_lookups": self.prefix_index.lookups,
                "prefix_hits": self.prefix_index.hits,
                "prefix_pages_cached": self.prefix_index.num_pages,
                "prefix_evictions": self.prefix_index.evictions,
                "prefix_shared_tokens": self._shared_tokens,
                "cow_copies": self.cow_copies,
            })
        return out


def make_backend(config):
    """The cache backend ``config.backend`` names (an ``EngineConfig``),
    shaped by its page size, pool size, KV dtype and prefix cache."""
    if config.backend == "dense":
        return DenseBackend()
    if config.backend == "paged":
        return PagedBackend(
            page_size=resolve_page_size(config), num_pages=config.num_pages,
            kv_dtype="int8" if config.kv_cache_dtype == "int8" else None,
            prefix_cache=config.prefix_cache)
    raise ValueError(f"unknown cache backend {config.backend!r}")


def bucket_length(n: int, min_bucket: int = 8,
                  cap: Optional[int] = None) -> int:
    """Power-of-2 prefill bucket for a prompt of length ``n``: one captured
    prefill graph per bucket, ever."""
    b = max(min_bucket, 1 << max(0, math.ceil(math.log2(max(n, 1)))))
    if cap is not None:
        b = min(b, cap)
    return b
