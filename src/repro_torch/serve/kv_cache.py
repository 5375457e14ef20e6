"""Paged KV cache: fixed-size pages, per-sequence page tables.

Each layer's K/V lives in a shared physical pool of fixed-size pages:

    k_pages, v_pages : (n_pages, kv_heads, page_size, head_dim)   per layer
    page_table       : (batch_slots, max_pages)  int32  physical page ids
    lengths          : (batch_slots,)            int32  tokens written

Physical **page 0 is reserved as the null page**: never allocated, pointed
at by every unused page-table entry, and absorbing the writes of inactive
batch slots. Ragged occupancy lives in the page table and the length mask,
not in array shapes.

Split of responsibilities:

* array ops (:func:`append_paged_kv`, :func:`write_prefill_pages`,
  :func:`gather_pages`) run on the pools' device. Unlike the functional
  reference they update the pools **in place** and return them; duplicate
  writes into the null page race harmlessly under ``index_put_``, since the
  null page is never read unmasked.
* bookkeeping (:class:`PageAllocator`, :class:`PrefixCache`,
  :func:`init_page_state`, :func:`assign_slot`, :func:`release_slot`) runs
  on the host. The page table and lengths are host numpy arrays that the
  engine owns and uploads once per launch.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

NULL_PAGE = 0


def num_pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, -(-n_tokens // page_size))


def init_page_pool(n_pages: int, kv_heads: int, page_size: int,
                   head_dim: int, dtype, device) -> dict:
    """One layer's physical K/V pools (page 0 included, reserved null)."""
    shape = (n_pages, kv_heads, page_size, head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def init_page_state(batch_slots: int, max_pages: int) -> dict:
    """Per-sequence table + lengths on the host, all slots empty."""
    return {"page_table": np.zeros((batch_slots, max_pages), np.int32),
            "lengths": np.zeros((batch_slots,), np.int32)}


# ---------------------------------------------------------------------------
# Array ops (on the pools' device, in place)
# ---------------------------------------------------------------------------

def append_paged_kv(k_pages, v_pages, k_new, v_new, page_table, lengths):
    """Append T tokens' K/V per sequence at its write position, in place.

    k_new/v_new: (B, kv_heads, T, head_dim); token t of sequence b lands in
    page ``page_table[b, (lengths[b]+t) // page_size]`` at offset
    ``(lengths[b]+t) % page_size``. ``page_table`` (B, MP) and ``lengths``
    (B,) are integer tensors on the pools' device. A table index past the
    row is clamped to its last entry, as the reference's gather clamps.
    Inactive slots (empty table rows) write into the null page.
    """
    b, _, t_tokens, _ = k_new.shape
    page_size = k_pages.shape[2]
    pos = lengths.long()[:, None] + torch.arange(t_tokens,
                                                 device=k_new.device)
    col = torch.clamp(pos // page_size, max=page_table.shape[1] - 1)
    pidx = torch.gather(page_table.long(), 1, col)          # (B, T)
    off = pos % page_size
    # advanced indices around a slice: the indexed view is (B, T, Hkv, D)
    k_pages[pidx, :, off] = k_new.transpose(1, 2)
    v_pages[pidx, :, off] = v_new.transpose(1, 2)
    return k_pages, v_pages


def write_prefill_pages(k_pages, v_pages, k, v, page_rows, start_page=0):
    """Write one sequence's prefill K/V into its allocated pages, in place.

    k/v: (1, kv_heads, S, head_dim); ``page_rows``: (max_pages,) the
    sequence's page-table row (host array or tensor). S is padded up to a
    whole number of pages; tokens past the true length are garbage until
    overwritten by appends, and stay masked by ``lengths`` until then.
    ``start_page`` offsets the destination within the row (chunk c of C
    tokens writes at ``c * C // page_size``); rows past the end of
    ``page_rows`` land in the null page, so a padded final chunk writes
    harmlessly to page 0.
    """
    _, hkv, s, d = k.shape
    page_size = k_pages.shape[2]
    n = num_pages_needed(s, page_size)
    pad = n * page_size - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    # (1, hkv, n*page, d) -> (n, hkv, page, d)
    kr = k.reshape(hkv, n, page_size, d).transpose(0, 1)
    vr = v.reshape(hkv, n, page_size, d).transpose(0, 1)
    all_rows = np.asarray(page_rows.cpu() if torch.is_tensor(page_rows)
                          else page_rows, np.int64)
    idx = start_page + np.arange(n)
    rows = np.where(idx < all_rows.shape[0],
                    all_rows[np.clip(idx, 0, all_rows.shape[0] - 1)],
                    NULL_PAGE)
    rows = torch.from_numpy(rows).to(k_pages.device)
    k_pages[rows] = kr.to(k_pages.dtype)
    v_pages[rows] = vr.to(v_pages.dtype)
    return k_pages, v_pages


def gather_pages(pages, page_table):
    """Contiguous (B, kv_heads, max_pages*page_size, head_dim) copy: the
    reference path and a debugging aid (the kernel never builds it)."""
    b, mp = page_table.shape
    _, hkv, page_size, d = pages.shape
    return pages[page_table.long()].transpose(1, 2).reshape(
        b, hkv, mp * page_size, d)


# ---------------------------------------------------------------------------
# Host-side bookkeeping (between launches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PageAllocator:
    """Refcounted free-list allocator over pages 1..n_pages-1 (0 = null).

    ``alloc`` hands out pages with refcount 1; ``retain`` adds a reference
    (prefix-cache sharing: a matched page is held by the trie *and* every
    sequence whose table row points at it); ``free`` drops one reference
    and only returns the page to the free list when the count hits zero.
    Freeing an unallocated page is a hard error: double frees would corrupt
    shared prefixes silently otherwise.
    """

    n_pages: int

    def __post_init__(self):
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> low ids
        self._refs = [0] * self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV cache exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.n_pages - 1}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, page: int) -> int:
        """Add a reference to an already-allocated page; returns new count."""
        if not 0 < page < self.n_pages:
            raise ValueError(f"retaining invalid page id {page}")
        if self._refs[page] == 0:
            raise ValueError(f"retaining unallocated page {page}")
        self._refs[page] += 1
        return self._refs[page]

    def refcount(self, page: int) -> int:
        if not 0 <= page < self.n_pages:
            raise ValueError(f"invalid page id {page}")
        return self._refs[page]

    def free(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if self._refs[p] == 0:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


class PrefixCache:
    """Trie of immutable full KV pages keyed by their exact token content.

    Each node is one *full* page of a previously prefilled prompt, keyed by
    the chain of page-token-tuples leading to it: exact token match, no
    hash collisions. A node holds one reference on its page (via
    :meth:`PageAllocator.retain` at insert), so cached pages survive the
    sequences that created them and are handed out to later requests whose
    prompts share the prefix.

    COW rule: only whole pages are ever shared, and :meth:`match` stops at
    ``(len(tokens) - 1) // page_size`` full pages, so at least the final
    prompt token is always recomputed privately (its logits seed the first
    sampled token). Decode appends land at positions >= the matched region,
    i.e. in private pages: shared pages are immutable by construction.

    Eviction is LRU over *leaf* nodes whose page is referenced only by the
    trie (refcount 1): interior nodes are never dropped before their
    children, so no cached page becomes unreachable.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._nodes = collections.OrderedDict()  # key -> {page, children}
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0

    def __len__(self):
        return len(self._nodes)

    @property
    def pages_held(self) -> int:
        return len(self._nodes)

    def _key_chain(self, tokens):
        """Full-page token tuples of ``tokens``, shareable region only."""
        n_share = max(0, (len(tokens) - 1) // self.page_size)
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_share)]

    def match(self, tokens, alloc: PageAllocator) -> list:
        """Longest cached page-prefix of ``tokens``; retains each hit.

        Returns the matched physical page ids (possibly none). The caller
        owns one reference per returned page and must ``free`` them when
        the sequence retires or is preempted.
        """
        self.lookups += 1
        pages, key = [], ()
        for chunk in self._key_chain(tokens):
            key = key + (chunk,)
            node = self._nodes.get(key)
            if node is None:
                break
            alloc.retain(node["page"])
            self._nodes.move_to_end(key)
            pages.append(node["page"])
        if pages:
            self.hits += 1
            self.matched_tokens += len(pages) * self.page_size
        return pages

    def insert(self, tokens, pages, alloc: PageAllocator) -> int:
        """Register ``tokens``'s full pages (backed by ``pages``) for reuse.

        ``pages`` is the sequence's page-table prefix. Nodes already present
        are skipped (the sequence got those exact pages from :meth:`match`);
        new nodes retain their page so it outlives the sequence. Returns the
        number of new nodes.
        """
        added = 0
        key = ()
        for i, chunk in enumerate(self._key_chain(tokens)):
            key = key + (chunk,)
            node = self._nodes.get(key)
            if node is not None:
                self._nodes.move_to_end(key)
                continue
            alloc.retain(pages[i])
            self._nodes[key] = {"page": int(pages[i]), "children": 0}
            if len(key) > 1:
                self._nodes[key[:-1]]["children"] += 1
            added += 1
        return added

    def evict(self, alloc: PageAllocator, need: int) -> int:
        """Drop up to ``need`` LRU leaf pages held only by the trie.

        Returns how many pages went back to the free list. Pages still
        referenced by a live sequence (refcount > 1) are skipped: dropping
        the trie's reference would not free them and would orphan a
        shareable page.
        """
        freed = 0
        progress = True
        while freed < need and progress:
            progress = False
            for key in list(self._nodes):  # OrderedDict: LRU first
                node = self._nodes[key]
                if node["children"] or alloc.refcount(node["page"]) != 1:
                    continue
                alloc.free([node["page"]])
                del self._nodes[key]
                if len(key) > 1:
                    self._nodes[key[:-1]]["children"] -= 1
                freed += 1
                progress = True
                if freed >= need:
                    break
        return freed


def assign_slot(state: dict, slot: int, pages, length: int) -> dict:
    """Point ``slot``'s table row at ``pages`` and set its length, in place."""
    state["page_table"][slot] = 0
    state["page_table"][slot, : len(pages)] = pages
    state["lengths"][slot] = length
    return state


def release_slot(state: dict, slot: int) -> dict:
    """Reset ``slot`` to an empty (null-page, zero-length) row, in place."""
    state["page_table"][slot] = 0
    state["lengths"][slot] = 0
    return state
