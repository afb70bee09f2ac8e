"""Block-granular paged KV cache with prefix reuse (counterpart of
`mxnet_tpu/pages.py`).

  * **PagePool** — the KV store is one pooled (pages, H, page_size, D)
    tensor per layer on the model's device; a request owns a LIST of
    fixed-size pages. Pages are refcounted on the host: the prefix tree
    and every request sharing a block hold one reference each, and a
    page returns to the free list when the last reference drops.
  * **PrefixTree** — a content-hashed radix tree over FULL prompt
    blocks, host-side, copied from the JAX package as it is. A later
    request walks its prompt block by block and starts mid-cache with
    the matched pages mapped into its page table. Hash collisions are
    harmless: every node stores its block tokens and parent digest.
  * **copy-on-write** — a request never writes a page it does not own
    exclusively; a whole-prompt match copies the shared last page
    (`PagePool.copy_page`, in place in every pooled tensor).

Layout invariant: page id `p` addresses physical row `p` in EVERY
pooled tensor (all layers, K and V). Pages `0..scratch-1` are per-slot
scratch: masked-out rows of a batched step write there, so real pages
are never polluted.
"""
from __future__ import annotations

import collections
import hashlib
import itertools

import numpy as np
import torch

from . import context

__all__ = ["PagePool", "PrefixTree", "PagesExhausted",
           "enable", "disable", "enabled"]

_enabled = False


def enabled():
    """True while a paged server is armed (serve.Server(pages='on')
    builds the pool and sets it; the pages='off' path never reaches
    this module)."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def _torch_dtype(dt):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dt, torch.dtype):
        return dt
    from .gluon.parameter import dtype_of
    return dtype_of(np.dtype(dt).name)


class PagesExhausted(RuntimeError):
    """The pool cannot satisfy an allocation."""

    def __init__(self, need, free):
        self.need = int(need)
        self.free = int(free)
        super().__init__(
            f"page pool exhausted: need {need} pages, {free} free")


def _block_digest(parent, block_bytes):
    """Content hash of one prompt block, chained through the parent
    digest — the radix-tree node key. Collisions are tolerated (nodes
    verify tokens + parent on lookup)."""
    return hashlib.blake2b(parent + block_bytes, digest_size=16).digest()


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------

class PagePool:
    """Refcounted fixed-size KV pages over pooled per-layer tensors.

    `streams` maps a tag ('target') to a list of (heads, head_dim,
    dtype) specs, one per pooled tensor (2 * n_layers: K then V; a
    torch or numpy dtype). Every
    tensor is allocated as (pages, heads, page_size, head_dim) zeros on
    `device` (the card unless the caller names another); page id p is
    physical row p in all of them. Refcounts and the free list live on
    the host, guarded by the owning Server's lock; the page tensors are
    written in place by the scheduler thread only."""

    def __init__(self, page_size, data_pages, scratch_pages, streams,
                 device=None):
        if page_size < 1 or data_pages < 1:
            raise ValueError(
                f"PagePool needs page_size >= 1 and data_pages >= 1, got "
                f"{page_size}/{data_pages}")
        dev = context.resolve(device)
        self.page_size = int(page_size)
        self.scratch = int(scratch_pages)
        self.num_pages = self.scratch + int(data_pages)
        self.refcount = np.zeros(self.num_pages, np.int32)
        self.free = collections.deque(range(self.scratch, self.num_pages))
        self.state = {
            tag: [torch.zeros((self.num_pages, h, self.page_size, d),
                              dtype=_torch_dtype(dt), device=dev)
                  for (h, d, dt) in specs]
            for tag, specs in streams.items()}
        self.stats = {"allocs": 0, "frees": 0, "cow_copies": 0,
                      "peak_used": 0}

    # -- accounting ------------------------------------------------------
    @property
    def data_pages(self):
        return self.num_pages - self.scratch

    def free_pages(self):
        return len(self.free)

    def used_pages(self):
        return self.data_pages - len(self.free)

    def pool_bytes(self):
        return sum(a.numel() * a.element_size()
                   for arrs in self.state.values() for a in arrs)

    # -- alloc / refcount ------------------------------------------------
    def alloc(self, n):
        """Take `n` pages off the free list (refcount 1 each). Raises
        PagesExhausted when the list is short; nothing is allocated
        partially."""
        if n > len(self.free):
            raise PagesExhausted(n, len(self.free))
        pages = [self.free.popleft() for _ in range(int(n))]
        for p in pages:
            self.refcount[p] = 1
        self.stats["allocs"] += len(pages)
        self.stats["peak_used"] = max(self.stats["peak_used"],
                                      self.used_pages())
        return pages

    def incref(self, page):
        if self.refcount[page] <= 0:
            raise RuntimeError(f"incref on free page {page}")
        self.refcount[page] += 1

    def decref(self, page):
        """Drop one reference; the page returns to the free list when
        the count reaches zero (its stale contents are harmless — every
        position is rewritten before the causal mask can see it)."""
        c = int(self.refcount[page])
        if c <= 0:
            raise RuntimeError(f"decref on free page {page}")
        self.refcount[page] = c - 1
        if c == 1:
            self.free.append(int(page))
            self.stats["frees"] += 1

    def copy_page(self, src):
        """Copy-on-write: allocate a fresh page and copy `src`'s row into
        it in place, in every pooled tensor. Returns the new page id; the
        caller drops its shared reference on `src`."""
        (dst,) = self.alloc(1)
        for arrs in self.state.values():
            for a in arrs:
                a[dst].copy_(a[src])
        self.stats["cow_copies"] += 1
        return dst


# ---------------------------------------------------------------------------
# PrefixTree
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("digest", "parent", "block", "page", "children",
                 "last_used")

    def __init__(self, digest, parent, block, page, stamp):
        self.digest = digest
        self.parent = parent          # parent digest (b"" at the root)
        self.block = block            # the block's token bytes
        self.page = int(page)
        self.children = set()         # child digests
        self.last_used = stamp


class PrefixTree:
    """Content-hashed radix tree over full prompt blocks: digest(node) =
    blake2b(digest(parent) + block_tokens). Only FULL pages are shared —
    a partial tail block stays exclusively owned by its request (the
    "partial-block tail" rule the tests pin).

    The tree holds ONE pool reference per node; `match` bumps the
    refcount of every returned page (the caller owns those references),
    `insert` adopts a request's page into a new node (one more ref),
    and `evict` walks leaf nodes LRU-first, dropping the tree's
    reference so idle cached pages return to the pool under pressure."""

    def __init__(self, pool):
        self.pool = pool
        self.nodes = {}                         # digest -> _Node
        self.roots = set()                      # digests with parent b""
        self._stamp = itertools.count(1)        # deterministic LRU clock
        self.stats = {"hits": 0, "misses": 0, "matched_tokens": 0,
                      "inserted_pages": 0, "evicted_pages": 0}

    def __len__(self):
        return len(self.nodes)

    def reclaimable(self):
        """Pages that only this tree holds (refcount 1): what `evict` can
        return to the pool's free list, leaf by leaf, for an admission."""
        return sum(1 for n in self.nodes.values()
                   if self.pool.refcount[n.page] == 1)

    def _blocks(self, prompt):
        ps = self.pool.page_size
        prompt = np.asarray(prompt, np.int32)
        n_full = prompt.size // ps
        return [prompt[i * ps:(i + 1) * ps].tobytes()
                for i in range(n_full)]

    def match(self, prompt):
        """Walk the prompt's full blocks down the tree. Returns
        (pages, matched_tokens): the shared pages (refcount bumped —
        the caller now owns one reference each) covering the longest
        cached prefix. A digest hit whose stored tokens or parent
        disagree (hash collision) stops the walk — correctness never
        rests on the hash."""
        pages, parent = [], b""
        for block in self._blocks(prompt):
            digest = _block_digest(parent, block)
            node = self.nodes.get(digest)
            if node is None or node.block != block \
                    or node.parent != parent:
                break
            node.last_used = next(self._stamp)
            self.pool.incref(node.page)
            pages.append(node.page)
            parent = digest
        matched = len(pages) * self.pool.page_size
        if pages:
            self.stats["hits"] += 1
            self.stats["matched_tokens"] += matched
        else:
            self.stats["misses"] += 1
        return pages, matched

    def insert(self, prompt, pages):
        """Register a prefilled prompt's FULL blocks: `pages[i]` holds
        block i's K/V. Existing nodes are refreshed (their page stays
        authoritative — concurrent identical prefills do not
        duplicate); new nodes adopt the request's page with one more
        reference. Safe to call again after a requeue replay."""
        parent = b""
        for i, block in enumerate(self._blocks(prompt)):
            if i >= len(pages):
                break
            digest = _block_digest(parent, block)
            node = self.nodes.get(digest)
            if node is not None and (node.block != block
                                     or node.parent != parent):
                break                    # collision: stop registering
            if node is None:
                node = _Node(digest, parent, block, pages[i],
                             next(self._stamp))
                self.nodes[digest] = node
                if parent == b"":
                    self.roots.add(digest)
                else:
                    self.nodes[parent].children.add(digest)
                self.pool.incref(node.page)
                self.stats["inserted_pages"] += 1
            else:
                node.last_used = next(self._stamp)
            parent = digest

    def evict(self, need_free):
        """Drop tree references, LRU leaf first, until the pool has
        `need_free` free pages or no leaf remains. Returns the number of
        nodes evicted (a node whose page is still shared by a running
        request is evicted from the TREE but only returns to the pool
        when that request drains)."""
        evicted = 0
        while self.pool.free_pages() < need_free:
            leaves = [n for n in self.nodes.values() if not n.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            self._drop(victim)
            evicted += 1
        return evicted

    def clear(self):
        """Drop every tree reference (server shutdown)."""
        n = len(self.nodes)
        while self.nodes:
            leaves = [d for d, node in self.nodes.items()
                      if not node.children]
            for d in leaves:
                self._drop(self.nodes[d])
        return n

    def _drop(self, node):
        del self.nodes[node.digest]
        if node.parent == b"":
            self.roots.discard(node.digest)
        else:
            p = self.nodes.get(node.parent)
            if p is not None:
                p.children.discard(node.digest)
        self.pool.decref(node.page)
        self.stats["evicted_pages"] += 1
