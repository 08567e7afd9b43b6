"""Radix-tree prompt-prefix cache for the generation engine.

A copy of the JAX package's ``deeplearning4j_tpu/parallel/prefix_cache.py``
(which imports no JAX) with one divergence: a page is ONE torch tensor
``[page_tokens, width]`` (every layer's k and v, flattened side by side:
width = sum of 2 * heads * head_size) that stays on the device it was made
on (the engine cuts it out of a prefill's kv in one copy), and
:meth:`PrefixCache.assemble` concatenates a path's pages in one call
straight into a caller's block on that device. The JAX package keeps
per-layer host numpy copies; on a CUDA card that would move every hit's
pages host to device again at each suffix prefill, and per-layer tensors
cost a copy per layer and key.

Shared-prefix serving traffic (few-shot templates, system prompts, chat
history) re-prefills the same prompt head for every request.  This module
keeps a token-keyed radix tree whose nodes own **pages** — fixed-size
blocks of per-layer KV activations captured from a finished prefill.  A new
request walks the tree under the lock, pins the longest cached prefix
(whole-path refcount increment), and only its suffix is prefilled; the
engine scatters the pinned pages into the joining row's cache with the
``prefix_attach`` executable.

Correctness rules the engine relies on:

- ``match`` increments the refcount of EVERY node on the returned path
  before the lock is released, so eviction can never free a page a
  request is about to attach.  Each node is released exactly once per
  request on every terminal edge (finish, queue expiry, mid-generation
  deadline, dispatch failure, engine close).
- Pages are page-aligned and immutable once inserted: a node's KV block
  is only ever read after insertion, so hits are bit-identical to the
  cold prefill that produced them.
- Eviction only considers refcount-0 leaves, oldest ``last_used`` first
  (LRU).  Interior nodes become evictable leaves once their children go.
"""

import itertools
import threading

import torch

from deeplearning4j_tpu_torch import telemetry


class _Node:
    """One radix-tree node: ``page_tokens`` tokens of KV, keyed by the
    token tuple, children keyed by their own token tuples."""

    __slots__ = ("key", "kv", "children", "parent", "refs", "last_used")

    def __init__(self, key, kv, parent):
        self.key = key            # tuple of page_tokens token ids
        self.kv = kv              # [t, width]: every layer's k, v
        self.children = {}        # key tuple -> _Node
        self.parent = parent
        self.refs = 0
        self.last_used = 0


class PrefixCache:
    """Refcounted, LRU-evicted radix tree of prompt-prefix KV pages."""

    def __init__(self, page_tokens=16, max_pages=256):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        self.page_tokens = int(page_tokens)
        self.max_pages = int(max_pages)
        self._root = _Node((), None, None)   # sentinel, never evicted
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._pages = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # -- lookup ------------------------------------------------------------

    def match(self, tokens, limit=None, fits=None):
        """Walk the tree along ``tokens`` and pin the longest cached
        prefix.  ``limit`` caps the matched token count (the engine
        passes ``n - 1`` so at least one suffix token remains to sample
        from).  ``fits(m)`` — when given — must return True for a match
        of ``m`` tokens to be usable; the walk backs off page by page
        until it does (the engine uses this to reject matches whose
        suffix bucket would overflow ``max_len``).

        Returns ``(matched_tokens, nodes)``; every node in ``nodes`` has
        had its refcount incremented and MUST be handed back exactly
        once via :meth:`release`."""
        pt = self.page_tokens
        with self._lock:
            path = []
            node = self._root
            m = 0
            while True:
                if limit is not None and m + pt > limit:
                    break
                key = tuple(tokens[m:m + pt])
                if len(key) < pt:
                    break
                child = node.children.get(key)
                if child is None:
                    break
                path.append(child)
                node = child
                m += pt
            while path and fits is not None and not fits(m):
                path.pop()
                m -= pt
            for nd in path:
                nd.refs += 1
                nd.last_used = next(self._clock)
            if path:
                self._hits += 1
            else:
                self._misses += 1
            pages = self._pages
        telemetry.record_prefix_cache(hits=int(bool(path)),
                                      misses=int(not path),
                                      pages=pages, hit_tokens=m)
        return m, path

    def release(self, nodes):
        """Drop one pin from each node in ``nodes`` (a ``match`` /
        ``insert`` result).  Safe with an empty list."""
        if not nodes:
            return
        with self._lock:
            for nd in nodes:
                if nd.refs > 0:
                    nd.refs -= 1

    # -- insert ------------------------------------------------------------

    def insert(self, tokens, n, slicer):
        """Insert full pages covering ``tokens[:n]`` that are not in the
        tree yet.  ``slicer(start, stop)`` returns the KV block for that
        token span — called only for pages actually created, so the
        engine copies new pages alone.

        Returns the list of nodes on the inserted path with refcounts
        already incremented (the caller owns one pin per node, same
        contract as ``match``) — the engine keeps them pinned until the
        request terminates so a request's own pages cannot be evicted
        under it."""
        pt = self.page_tokens
        full = (int(n) // pt) * pt
        evicted = 0
        with self._lock:
            path = []
            node = self._root
            for start in range(0, full, pt):
                key = tuple(tokens[start:start + pt])
                child = node.children.get(key)
                if child is None:
                    kv = slicer(start, start + pt)
                    child = _Node(key, kv, node)
                    node.children[key] = child
                    self._pages += 1
                child.refs += 1
                child.last_used = next(self._clock)
                path.append(child)
                node = child
            evicted = self._evict_locked()
            pages = self._pages
        telemetry.record_prefix_cache(evictions=evicted, pages=pages)
        return path

    def _evict_locked(self):
        """LRU-evict refcount-0 leaves until the page budget holds."""
        evicted = 0
        while self._pages > self.max_pages:
            victim = None
            stack = [self._root]
            while stack:
                nd = stack.pop()
                for child in nd.children.values():
                    if child.children:
                        stack.append(child)
                    elif child.refs == 0 and (
                            victim is None
                            or child.last_used < victim.last_used):
                        victim = child
            if victim is None:      # everything pinned; over budget stays
                break
            del victim.parent.children[victim.key]
            victim.parent = None
            self._pages -= 1
            evicted += 1
        self._evictions += evicted
        return evicted

    # -- introspection -----------------------------------------------------

    def stats(self):
        with self._lock:
            return {"pages": self._pages, "hits": self._hits,
                    "misses": self._misses, "evictions": self._evictions,
                    "page_tokens": self.page_tokens,
                    "max_pages": self.max_pages}

    def assemble(self, nodes, out):
        """Concatenate a pinned path's pages along the token axis, in one
        call, into the head of ``out`` (a ``[tokens, width]`` block on the
        pages' device, zero-filled by the caller: the engine passes one row
        of its padded ``[rows, tpre, width]`` group block). Returns the
        number of tokens written."""
        if not nodes:
            raise ValueError("assemble needs a non-empty node path")
        t = sum(nd.kv.shape[0] for nd in nodes)
        torch.cat([nd.kv for nd in nodes], dim=0, out=out[:t])
        return t
