"""Free-list page allocator over the shared ``PagedMLAPool`` (a copy of
``repro/serving/allocator.py``; the port keeps its own so it imports
nothing of the JAX package).

The pool (``kvcache.init_paged_mla_cache(..., n_pages=N)``) is a flat array
of physical pages; this allocator is the host-side owner of those pages for
the continuous-batching engine:

  * **free list** — LIFO stack of physical page ids; ``alloc_prompt`` /
    ``grow`` pop, ``free`` pushes back once a page's refcount hits zero.
  * **radix prefix cache** — prompts are chunked into full pages and each
    full-page prefix is a node of a radix tree (``prefix_tree.PrefixTree``)
    keyed by a hash of its *token content*; a new request whose prompt
    starts with a resident prefix maps the same physical pages (refcount
    bumped) and only allocates private pages from the first divergent page
    onward. The page a shared prefix ends in (a partially-filled page) is
    never shared — it is copied by re-prefilling its tokens into a private
    page (copy-on-write at the boundary page), which keeps decode appends
    strictly out of shared pages.
  * **retention** (``prefix_cache_pages > 0``) — a refcount-0 prefix page is
    RETAINED as ``cached`` instead of freed, up to the budget; over-budget
    pages are evicted LRU (leaf-first on ties). A later prompt matching a
    cached page promotes it back to refcount 1 with zero recompute — the
    chunked-prefill path then skips those pages entirely (TTFT tracks the
    uncached suffix). Every non-scratch page is exactly one of
    {free, cached, in_use}.
  * **host tier** (``host_tier``) — an LRU-evicted cached page offloads its
    FP8 bytes to a host-tier slot instead of dropping; a match
    against a host-resident node allocates a fresh device page and queues a
    restore. The allocator only *decides* placement: data movement rides a
    pending-op queue (``take_pending_tier_ops``) the engine drains before
    any device write can clobber the source/target pages. The port's
    engine has no host tier yet, so it always passes ``host_tier=None`` and
    these paths stay dormant.
  * **metrics** — utilization, fragmentation, cumulative pages saved by
    sharing, cache hit/restore counters, in-use and resident (HBM
    high-water) peaks.

Physical page 0 is reserved as the scratch page: idle batch slots park their
page-table rows on it (the decode step appends unconditionally for
every slot; scratch writes are never read back because masked by seq_lens),
so it is never handed out. ``capacity`` is therefore ``n_pages - 1``.

Everything here is plain Python/NumPy — no device code. The engine pushes
the resulting page tables into the decode state via
``kvcache.pool_with_tables``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from typing import Any

from repro_torch.serving.prefix_tree import PrefixNode, PrefixTree


def _prefix_key(prompt: np.ndarray, n_tokens: int) -> bytes:
    """Content hash of the first ``n_tokens`` prompt tokens (page-aligned
    chunk boundary). Token-content keyed, so textual prefix equality —
    not request identity — is what shares pages."""
    return hashlib.sha256(
        np.ascontiguousarray(prompt[:n_tokens], dtype=np.int64).tobytes()
    ).digest()


class PromptAlloc(list):
    """``alloc_prompt`` result: behaves exactly like the plain page-id list
    it always was (logical page i -> self[i]), plus the cache-hit facts the
    scheduler/engine need to skip prefill for matched pages."""

    cached_tokens: int = 0     # leading tokens already resident (skip prefill)
    reused_pages: int = 0      # refcount-0 cached pages promoted back in use
    restored_pages: int = 0    # pages queued for host-tier restore


@dataclasses.dataclass
class AllocStats:
    n_pages: int                 # physical pages incl. the scratch page
    capacity: int                # allocatable pages (n_pages - 1)
    free: int                    # pages currently on the free list
    in_use: int                  # pages with refcount >= 1
    shared: int                  # pages with refcount >= 2
    cached: int                  # refcount-0 prefix pages retained (LRU)
    resident: int                # in_use + cached (pages holding live data)
    peak_in_use: int             # high-water mark of in_use
    peak_resident: int           # high-water mark of in_use + cached (HBM)
    total_allocs: int            # cumulative fresh-page allocations
    pages_saved_by_sharing: int  # cumulative prefix hits (alloc avoided)
    pages_reused_cached: int     # ..of which refcount-0 retained pages
    pages_restored_host: int     # prefix hits restored from the host tier
    host_offloads: int           # cached pages offloaded to the host tier
    cache_drops: int             # cached pages dropped (no tier room)
    host_used: int               # host-tier slots in use
    utilization: float           # in_use / capacity
    # slack inside the page runs requests actually reference: 1 -
    # live_tokens / (page_references * page). The denominator counts a
    # shared page once PER REFERENCING REQUEST (sum of refcounts), matching
    # live_tokens' per-request accounting — with sharing, physical in_use
    # alone would undercount and drive this negative.
    fragmentation: float


class PageAllocator:
    """Multi-tenant free-list allocator with a radix prefix cache."""

    SCRATCH_PAGE = 0

    def __init__(self, n_pages: int, page_size: int,
                 prefix_sharing: bool = True, prefix_cache_pages: int = 0,
                 host_tier: Any | None = None):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        if prefix_cache_pages and not prefix_sharing:
            raise ValueError("prefix_cache_pages requires prefix_sharing")
        if host_tier is not None and not prefix_cache_pages:
            raise ValueError("a host tier requires prefix_cache_pages > 0")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.prefix_cache_pages = int(prefix_cache_pages)
        self.host_tier = host_tier
        # LIFO free list over pages [1, n_pages); page 0 is scratch
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}          # page id -> refcount (>= 1)
        self._cached: set[int] = set()           # refcount-0 retained pages
        self.tree = PrefixTree() if self.prefix_sharing else None
        # placement decisions awaiting the engine's data movement, in strict
        # decision order: ("offload", page_id, slot) | ("restore", page_id,
        # slot). The engine drains BEFORE any prefill/decode write of the
        # step, so offload sources still hold their bytes and restore
        # targets are written before first use.
        self._pending: list[tuple[str, int, int]] = []
        self.total_allocs = 0
        self.pages_saved_by_sharing = 0
        self.pages_reused_cached = 0
        self.pages_restored_host = 0
        self.host_offloads = 0
        self.cache_drops = 0
        self.peak_in_use = 0
        self.peak_resident = 0

    # -- introspection ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return len(self._refs)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    def resident_pages(self) -> set[int]:
        """Pages currently holding live KV bytes: referenced by requests or
        cache-retained at refcount 0 (the set obs/quant_health probes)."""
        return set(self._refs) | set(self._cached)

    def stats(self, live_tokens: int = 0) -> AllocStats:
        in_use = self.num_in_use
        refs = sum(self._refs.values())
        return AllocStats(
            n_pages=self.n_pages, capacity=self.capacity, free=self.num_free,
            in_use=in_use,
            shared=sum(1 for r in self._refs.values() if r >= 2),
            cached=self.num_cached, resident=in_use + self.num_cached,
            peak_in_use=self.peak_in_use, peak_resident=self.peak_resident,
            total_allocs=self.total_allocs,
            pages_saved_by_sharing=self.pages_saved_by_sharing,
            pages_reused_cached=self.pages_reused_cached,
            pages_restored_host=self.pages_restored_host,
            host_offloads=self.host_offloads, cache_drops=self.cache_drops,
            host_used=self.host_tier.num_used if self.host_tier else 0,
            utilization=in_use / max(self.capacity, 1),
            fragmentation=(1.0 - live_tokens / (refs * self.page_size)
                           if refs else 0.0),
        )

    def check_invariants(self) -> None:
        """Partition invariant: every non-scratch page is exactly one of
        {free, cached, in_use}; refcounts positive; the prefix tree, cached
        set, and host tier are mutually consistent. Raises AssertionError
        (used by the property/storm tests)."""
        free = set(self._free)
        used = set(self._refs)
        cached = set(self._cached)
        assert len(free) == len(self._free), "duplicate page on free list"
        assert not (free & used), f"pages both free and in use: {free & used}"
        assert not (free & cached), \
            f"pages both free and cached: {free & cached}"
        assert not (used & cached), \
            f"pages both in use and cached: {used & cached}"
        assert free | used | cached == set(range(1, self.n_pages)), \
            "leaked/unknown pages"
        assert self.SCRATCH_PAGE not in free | used | cached, \
            "scratch page escaped"
        assert all(r >= 1 for r in self._refs.values()), "refcount < 1"
        assert len(cached) <= self.prefix_cache_pages, \
            "cached pages exceed the retention budget"
        if self.tree is None:
            assert not cached and not self._pending
            return
        self.tree.check()
        for pid, node in self.tree.by_page.items():
            assert pid in used or pid in cached, \
                f"tree page {pid} neither in use nor cached"
        for pid in cached:
            node = self.tree.by_page.get(pid)
            assert node is not None, f"cached page {pid} not in the tree"
            assert node.ready, f"cached page {pid} was never written"
        for node in self.tree.iter_nodes():
            if node.host_id is not None:
                assert node.ready, "host-offloaded page was never written"
            if not node.ready:
                assert node.page_id is not None \
                    and node.page_id in used, \
                    "not-ready node must be a live device page"
            # ready is prefix-monotone: a written child implies a written
            # parent (prefill lands left to right for every writer)
            if node.ready and node.parent is not None \
                    and node.parent.depth > 0:
                assert node.parent.ready, "ready child under unready parent"
        for node in self.tree.iter_nodes():
            # refcount monotonicity: a request references its WHOLE prefix
            # chain, so a child can never out-reference its parent (this is
            # what makes leaf-first LRU eviction safe: refcount-0 implies
            # the entire subtree is refcount-0)
            parent = node.parent
            if parent is not None and parent.depth > 0:
                child_refs = self._refs.get(node.page_id, 0) \
                    if node.page_id is not None else 0
                parent_refs = self._refs.get(parent.page_id, 0) \
                    if parent.page_id is not None else 0
                assert child_refs <= parent_refs, \
                    f"refcount monotonicity broken at depth {node.depth}"
        # pending ops reference live placements exactly once
        restore_slots = [s for kind, _, s in self._pending
                         if kind == "restore"]
        offload_slots = [s for kind, _, s in self._pending
                         if kind == "offload"]
        assert len(set(restore_slots)) == len(restore_slots), \
            "duplicate pending restore slot"
        for kind, pid, slot in self._pending:
            if kind == "restore":
                assert pid in used, "pending restore into a non-live page"
        if self.host_tier is not None:
            node_slots = {n.host_id for n in self.tree.iter_nodes()
                          if n.host_id is not None}
            assert len(node_slots) == sum(
                1 for n in self.tree.iter_nodes() if n.host_id is not None), \
                "host slot mapped by two nodes"
            # a pending offload's slot is either still node-referenced, or
            # the node re-matched before the drain and its page was already
            # re-handed out: the slot then carries a LATER pending restore
            # (drain order stores the bytes before the restore takes them)
            for i, (kind, _, slot) in enumerate(self._pending):
                if kind != "offload" or slot in node_slots:
                    continue
                assert any(k == "restore" and s == slot
                           for k, _, s in self._pending[i + 1:]), \
                    "pending offload into an unreferenced slot"
            self.host_tier.check(node_slots, set(restore_slots))
        else:
            assert not any(n.host_id is not None
                           for n in self.tree.iter_nodes()), \
                "host placement without a host tier"

    # -- checkpoint/restore (JSON-safe host state) --------------------------

    def export_state(self) -> dict:
        """JSON-serializable snapshot of the allocator's host state (free
        list ORDER matters — it is LIFO — so it is kept verbatim; the prefix
        tree rides as a node list, parents first). Together with the
        engine's request records, the host-tier payloads, and the device
        pool pages this is everything checkpoint-restore needs to resume
        allocation decisions bit-identically. Pending tier ops must be
        drained first (the engine drains before snapshotting)."""
        if self._pending:
            raise RuntimeError(
                "export_state with pending tier ops — drain first")
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "prefix_sharing": self.prefix_sharing,
            "prefix_cache_pages": self.prefix_cache_pages,
            "free": list(self._free),
            "refs": {str(pid): r for pid, r in self._refs.items()},
            "cached": sorted(self._cached),
            "tree": self.tree.export_state() if self.tree else None,
            "total_allocs": self.total_allocs,
            "pages_saved_by_sharing": self.pages_saved_by_sharing,
            "pages_reused_cached": self.pages_reused_cached,
            "pages_restored_host": self.pages_restored_host,
            "host_offloads": self.host_offloads,
            "cache_drops": self.cache_drops,
            "peak_in_use": self.peak_in_use,
            "peak_resident": self.peak_resident,
        }

    def restore_state(self, state: dict) -> None:
        if (state["n_pages"] != self.n_pages
                or state["page_size"] != self.page_size):
            raise ValueError(
                f"checkpointed allocator geometry ({state['n_pages']} pages "
                f"x {state['page_size']}) does not match this engine "
                f"({self.n_pages} x {self.page_size})")
        self.prefix_sharing = bool(state["prefix_sharing"])
        self.prefix_cache_pages = int(state.get("prefix_cache_pages", 0))
        self._free = [int(p) for p in state["free"]]
        self._refs = {int(pid): int(r) for pid, r in state["refs"].items()}
        self._cached = {int(p) for p in state.get("cached", [])}
        if self.prefix_sharing:
            self.tree = PrefixTree()
            if state.get("tree") is not None:
                self.tree.restore_state(state["tree"])
        else:
            self.tree = None
        self._pending = []
        self.total_allocs = int(state["total_allocs"])
        self.pages_saved_by_sharing = int(state["pages_saved_by_sharing"])
        self.pages_reused_cached = int(state.get("pages_reused_cached", 0))
        self.pages_restored_host = int(state.get("pages_restored_host", 0))
        self.host_offloads = int(state.get("host_offloads", 0))
        self.cache_drops = int(state.get("cache_drops", 0))
        self.peak_in_use = int(state["peak_in_use"])
        self.peak_resident = int(state.get("peak_resident", 0))
        self.check_invariants()

    # -- tier op queue (drained by the engine) ------------------------------

    def take_pending_tier_ops(self) -> list[tuple[str, int, int]]:
        """Hand the pending data-movement decisions (strict decision order)
        to the engine and clear the queue. ("offload", page, slot): copy the
        device page's bytes into the host slot (the page id is already on
        the free list but its bytes are intact until the engine's next
        device write — which is why the engine drains first). ("restore",
        page, slot): write the host slot's bytes into the freshly allocated
        device page and ``take`` (free) the slot."""
        ops, self._pending = self._pending, []
        return ops

    @property
    def has_pending_tier_ops(self) -> bool:
        return bool(self._pending)

    # -- allocation ---------------------------------------------------------

    def _note_usage(self) -> None:
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        self.peak_resident = max(self.peak_resident,
                                 self.num_in_use + self.num_cached)

    def _take_free(self) -> int:
        """Pop one fresh page (caller must have reserved room)."""
        pid = self._free.pop()
        self._refs[pid] = 1
        self.total_allocs += 1
        self._note_usage()
        return pid

    def _pop_free(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._take_free() for _ in range(n)]

    def _match_chain(self, prompt: np.ndarray) -> list[PrefixNode]:
        """Tree nodes covering the longest resident full-page prefix of
        ``prompt`` — THE sharing-match rule, shared by ``alloc_prompt`` and
        ``can_admit`` so the dry-run gate can never disagree with the real
        admission path. Read-only. Nodes may be device-resident (in-use or
        cached) or host-resident (restore needed); the chain is contiguous
        from the root because registration is."""
        if self.tree is None:
            return []
        chain: list[PrefixNode] = []
        for i in range(len(prompt) // self.page_size):
            node = self.tree.get(
                _prefix_key(prompt, (i + 1) * self.page_size))
            if node is None:
                break
            chain.append(node)
        return chain

    def _match_prefix(self, prompt: np.ndarray) -> list[int]:
        """Device-resident matched pages (back-compat helper)."""
        return [n.page_id for n in self._match_chain(prompt)
                if n.page_id is not None]

    def _evictable(self, protect: set[int]) -> list[PrefixNode]:
        if self.tree is None:       # sharing off: nothing is ever cached
            return []
        return [self.tree.by_page[pid] for pid in self._cached
                if pid not in protect]

    def _reserve_free(self, n: int, protect: set[int]) -> bool:
        """Ensure >= ``n`` pages on the free list, evicting LRU cached
        pages (never ones in ``protect`` — the current match's own chain)
        as needed. False = genuinely out of memory (admission gate)."""
        while len(self._free) < n:
            victims = self._evictable(protect)
            if not victims:
                return False
            # LRU first; on a tie (a whole chain released together) evict
            # the DEEPEST node first so parents outlive children and a drop
            # never orphans a resident subtree
            self._evict_cached(min(victims,
                                   key=lambda v: (v.last_use, -v.depth)))
        return True

    def _tier_slot(self) -> int | None:
        """A host slot for an offload, LRU-evicting a host-resident node
        when the tier is full. Slots owned by pending restores are not
        node-referenced, so they are never victims."""
        if self.host_tier is None or self.host_tier.n_slots == 0:
            return None
        slot = self.host_tier.alloc_slot()
        if slot is not None:
            return slot
        assert self.tree is not None
        hosted = [n for n in self.tree.iter_nodes() if n.host_id is not None]
        if not hosted:
            return None
        self._drop_host_node(min(hosted,
                                 key=lambda v: (v.last_use, -v.depth)))
        return self.host_tier.alloc_slot()

    def _cancel_pending_offload(self, slot: int) -> None:
        self._pending = [op for op in self._pending
                         if not (op[0] == "offload" and op[2] == slot)]

    def _unqueue_offload(self, node: PrefixNode) -> int | None:
        """Un-evict: when a prompt re-matches a host-placed node whose
        offload the engine has NOT drained yet, the page bytes never left
        the device. If the page is still on the free list, cancel the
        offload, release the host slot, and re-map the node to its original
        device page — no data movement in either direction."""
        slot = node.host_id
        for op in self._pending:
            if op[0] == "offload" and op[2] == slot:
                pid = op[1]
                if pid not in self._free:
                    return None       # page re-handed out: true restore
                self._cancel_pending_offload(slot)
                self._free.remove(pid)
                self.tree.clear_host(node)
                self.tree.set_device(node, pid)
                self.host_tier.drop(slot)
                self.host_offloads -= 1
                self._refs[pid] = 1
                self._note_usage()
                return pid
        return None

    def _revert_pending_restore(self, node: PrefixNode) -> bool:
        """The releasing request matched a host-placed prefix whose restore
        the engine never drained (the request retired first). The payload
        is still in the tier: cancel the restore, return the never-written
        device page to the free list, and re-place the node on its host
        slot — the whole round trip is saved. Returns True if reverted."""
        pid = node.page_id
        for i, op in enumerate(self._pending):
            if op[0] == "restore" and op[1] == pid:
                del self._pending[i]
                self.tree.clear_device(node)
                self.tree.set_host(node, op[2])
                self._free.append(pid)
                self.pages_restored_host -= 1
                return True
        return False

    def _drop_host_node(self, node: PrefixNode) -> None:
        """Evict a node's host copy (tier LRU). If that leaves the node
        resident nowhere, its subtree goes with it — descendants of a
        non-resident node are unreachable for matching and would leak."""
        slot = self.tree.clear_host(node)
        self._cancel_pending_offload(slot)
        self.host_tier.drop(slot)
        if node.page_id is None:
            self._drop_subtree(node)

    def _drop_subtree(self, node: PrefixNode) -> None:
        """Drop a no-longer-resident prefix subtree: cached descendants'
        pages return to the free list, host descendants' slots are
        released. Nothing here can be in use (refcount monotonicity: the
        root of the drop is refcount-0, so the whole subtree is)."""
        assert self.tree is not None
        for n in self.tree.subtree_postorder(node):
            pid = n.page_id
            if pid is not None:
                assert pid not in self._refs, "dropping an in-use prefix"
                self.tree.clear_device(n)
                self._cached.discard(pid)
                self._free.append(pid)
                self.cache_drops += 1
            if n.host_id is not None:
                slot = self.tree.clear_host(n)
                self._cancel_pending_offload(slot)
                self.host_tier.drop(slot)
            self.tree.remove(n)

    def _evict_cached(self, node: PrefixNode) -> None:
        """Evict one cached (refcount-0 retained) page: offload its bytes
        to the host tier when there is room, else drop its subtree."""
        pid = node.page_id
        assert pid is not None and pid in self._cached
        slot = self._tier_slot()
        if pid not in self._cached:
            # _tier_slot's host-LRU eviction dropped an ancestor that was
            # resident nowhere else — our victim went down with its subtree
            if slot is not None:
                self.host_tier.drop(slot)
            return
        if slot is None:
            self._drop_subtree(node)
            return
        self.tree.set_host(node, slot)
        self.tree.clear_device(node)
        self._cached.remove(pid)
        self._free.append(pid)
        self._pending.append(("offload", pid, slot))
        self.host_offloads += 1

    def _enforce_cache_budget(self) -> None:
        while len(self._cached) > self.prefix_cache_pages:
            victims = self._evictable(set())
            assert victims, "cached set inconsistent with the tree"
            self._evict_cached(min(victims,
                                   key=lambda v: (v.last_use, -v.depth)))

    def can_admit(self, prompt: np.ndarray) -> bool:
        """Would ``alloc_prompt`` succeed right now? (FCFS admission gate —
        does not mutate.) Mirrors ``alloc_prompt`` exactly: matched device
        pages cost nothing, host-resident matches and the unmatched
        remainder need fresh pages, and cached pages OUTSIDE the match are
        evictable headroom."""
        n_total = -(-len(prompt) // self.page_size)
        chain = self._match_chain(prompt)
        n_fresh = (n_total - len(chain)
                   + sum(1 for n in chain if n.page_id is None))
        protect = {n.page_id for n in chain if n.page_id is not None}
        evictable = len(self._cached - protect)
        return n_fresh <= len(self._free) + evictable

    def alloc_prompt(self, prompt: np.ndarray) -> PromptAlloc | None:
        """Allocate the page run covering ``prompt``. Returns the physical
        page ids (logical page i of the sequence -> pages[i]; a list
        subclass carrying ``cached_tokens``) or None if the free list plus
        evictable cached pages cannot cover the non-shared remainder
        (admission gate).

        Full pages of the prompt that match a resident prefix-tree node are
        mapped (refcount++ for in-use pages, promotion for cached pages, a
        queued host-tier restore for offloaded ones) instead of allocated;
        the remainder — including the partial tail page, which is the
        copy-on-write boundary — is allocated fresh. Fresh *full* prompt
        pages are registered in the tree so later requests can share them.
        """
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        page = self.page_size
        n_total = -(-len(prompt) // page)
        n_full = len(prompt) // page

        chain = self._match_chain(prompt)
        protect = {n.page_id for n in chain if n.page_id is not None}
        n_fresh = (n_total - len(chain)
                   + sum(1 for n in chain if n.page_id is None))
        if not self._reserve_free(n_fresh, protect):
            return None

        # only the leading READY run of the chain is a cache hit (prefill
        # skipped): a matched page whose writer's prefill has not landed yet
        # is shared refcount-style and REWRITTEN byte-identically by this
        # request, exactly the pre-cache behavior. ready is prefix-monotone
        # along any chain (pages are written left to right), so everything
        # past the first not-ready node is a live in-use device page.
        n_ready = 0
        for node in chain:
            if not node.ready:
                break
            n_ready += 1

        pages = PromptAlloc()
        for i, node in enumerate(chain):
            node.last_use = self.tree.tick()
            if i >= n_ready:
                assert node.page_id is not None and \
                    node.page_id not in self._cached, \
                    "not-ready prefix node must be live device-resident"
                self._refs[node.page_id] += 1
                self.pages_saved_by_sharing += 1
                pages.append(node.page_id)
                continue
            if node.page_id is not None:
                pid = node.page_id
                if pid in self._cached:           # promote cached -> in use
                    self._cached.remove(pid)
                    self._refs[pid] = 1
                    self.pages_reused_cached += 1
                    pages.reused_pages += 1
                else:                             # live refcount sharing
                    self._refs[pid] += 1
                self.pages_saved_by_sharing += 1
            else:                                 # host-resident: restore
                pid = self._unqueue_offload(node)
                if pid is not None:   # un-evict: bytes never left the device
                    self.pages_reused_cached += 1
                    self.pages_saved_by_sharing += 1
                    pages.reused_pages += 1
                else:
                    pid = self._take_free()
                    slot = self.tree.clear_host(node)
                    self.tree.set_device(node, pid)
                    self._pending.append(("restore", pid, slot))
                    self.pages_restored_host += 1
                    pages.restored_pages += 1
            pages.append(pid)
        pages.extend(self._take_free() for _ in range(n_total - len(chain)))
        self._note_usage()

        if self.tree is not None:
            # register this prompt's remaining FULL pages for future sharing
            # (the partial tail page stays private: decode appends land there)
            parent = chain[-1] if chain else self.tree.root
            for i in range(len(chain), n_full):
                key = _prefix_key(prompt, (i + 1) * page)
                if self.tree.get(key) is not None:
                    break       # unreachable by construction; stay private
                parent = self.tree.insert(key, parent, pages[i])
        pages.cached_tokens = n_ready * page
        return pages

    def mark_ready(self, pages: list[int], n_tokens: int) -> None:
        """Engine confirmation that the first ``n_tokens`` of a request's
        prompt have actually LANDED in ``pages`` (a prefill chunk or a
        monolithic prefill completed): the registered full pages below the
        cursor become matchable as cache hits and retainable at release."""
        if self.tree is None:
            return
        for pid in pages[:n_tokens // self.page_size]:
            node = self.tree.by_page.get(pid)
            if node is not None:
                node.ready = True

    def grow(self, n: int = 1) -> list[int] | None:
        """On-demand growth during decode: ``n`` fresh private pages
        (evicting LRU cached prefixes under memory pressure — a refcount-0
        retained page is always worth less than a live decode), or None
        when the pool is genuinely exhausted (the engine then evicts a
        request)."""
        if not self._reserve_free(n, set()):
            return None
        return self._pop_free(n)

    # -- release ------------------------------------------------------------

    def free(self, pages: list[int]) -> None:
        """Release one reference on each page of a retired request. A page
        whose refcount reaches zero is RETAINED as a cached prefix when it
        is a registered tree page and the retention budget allows —
        otherwise (or for private pages) it returns to the free list. With
        retention off the registry entry is purged on the way out (plain
        refcounted sharing)."""
        purge: list[PrefixNode] = []
        stamp = self.tree.tick() if self.tree is not None else 0
        for pid in pages:
            if pid == self.SCRATCH_PAGE:
                raise ValueError("scratch page cannot be freed")
            refs = self._refs.get(pid)
            if refs is None:
                raise ValueError(f"double free of page {pid}")
            if refs > 1:
                self._refs[pid] = refs - 1
                continue
            del self._refs[pid]
            node = self.tree.by_page.get(pid) if self.tree else None
            if node is not None and self._revert_pending_restore(node):
                continue
            # retention requires ready: an evicted-mid-prefill request's
            # registered-but-unwritten pages must never serve a cache hit
            if node is not None and self.prefix_cache_pages > 0 \
                    and node.ready:
                self._cached.add(pid)
                # ONE stamp for the whole released chain: the eviction
                # order's -depth tiebreak then walks it leaf-first, so a
                # drop never takes a hotter descendant down with a parent
                node.last_use = stamp
                continue
            if node is not None:
                purge.append(node)     # detach deepest-first, below
            self._free.append(pid)
        # a request's chain hits refcount 0 parent-first within this loop;
        # detach the nodes deepest-first so no parent is removed under a
        # still-attached child
        for node in sorted(purge, key=lambda n: -n.depth):
            self.tree.clear_device(node)
            self.tree.remove(node)
        self._enforce_cache_budget()
