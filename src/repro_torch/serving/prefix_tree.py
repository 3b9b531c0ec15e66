"""Radix/trie index over page-granular KV-prefix content hashes.

A copy of ``repro/serving/prefix_tree.py`` (the port imports nothing of the JAX package).

A flat ``hash(prefix) -> page`` dict would lose its entries with their last
referencing request. This tree is the *index* of a prefix cache that
SURVIVES request completion:

  * one node per full prompt page, keyed by the content hash of the whole
    token prefix ending at that page (the same chained ``_prefix_key``
    scheme the allocator has always used, so textual prefix equality — not
    request identity — is what matches);
  * explicit parent/child structure (node at depth ``d`` covers tokens
    ``[0, d * page_size)``; its parent covers one page less), which is what
    lets the allocator retain refcount-0 prefixes, evict them leaf-first
    under an LRU budget, and drop whole stale subtrees at once;
  * per-node *placement*: ``page_id`` (device-resident FP8 pool page) or
    ``host_id`` (slot in the host-memory second tier) — never both. A node
    with neither is removed on the spot; ``by_page`` inverts the
    device-resident mapping for O(1) "is this page a cached prefix?" checks.

The tree is a pure host-side index: it never touches array data and holds no
refcounts (the allocator owns both). ``last_use`` ticks off the tree's own
logical clock so LRU decisions are deterministic and checkpointable.
"""
from __future__ import annotations

from typing import Iterator


class PrefixNode:
    """One full prompt page's worth of cached KV prefix."""

    __slots__ = ("key", "parent", "children", "depth", "page_id", "host_id",
                 "last_use", "ready")

    def __init__(self, key: bytes, parent: "PrefixNode | None", depth: int,
                 page_id: int | None = None, host_id: int | None = None):
        self.key = key
        self.parent = parent
        self.children: dict[bytes, PrefixNode] = {}
        self.depth = depth                 # pages from the root (root = 0)
        self.page_id = page_id             # device pool page, if resident
        self.host_id = host_id             # host-tier slot, if offloaded
        self.last_use = 0
        # registration happens at ALLOC time but the page's bytes land
        # chunk-by-chunk: only a page whose prefill actually completed
        # (engine-confirmed via mark_ready) may satisfy a cache hit or be
        # retained — matching a just-allocated, still-unwritten page must
        # fall back to live sharing + byte-identical rewrite
        self.ready = False

    def __repr__(self) -> str:            # pragma: no cover - debugging aid
        where = (f"page={self.page_id}" if self.page_id is not None
                 else f"host={self.host_id}")
        return f"PrefixNode(depth={self.depth}, {where})"


class PrefixTree:
    """Prefix-page index: chained-hash lookup + parent/child structure."""

    def __init__(self) -> None:
        self.root = PrefixNode(b"", None, 0)
        self.nodes: dict[bytes, PrefixNode] = {}
        self.by_page: dict[int, PrefixNode] = {}
        self.clock = 0

    def __len__(self) -> int:
        return len(self.nodes)

    def tick(self) -> int:
        self.clock += 1
        return self.clock

    # -- lookup / structure -------------------------------------------------

    def get(self, key: bytes) -> PrefixNode | None:
        return self.nodes.get(key)

    def insert(self, key: bytes, parent: PrefixNode,
               page_id: int) -> PrefixNode:
        """Register a fresh device-resident prefix page under ``parent``."""
        if key in self.nodes:
            raise ValueError("prefix node already registered")
        node = PrefixNode(key, parent, parent.depth + 1, page_id=page_id)
        node.last_use = self.tick()
        parent.children[key] = node
        self.nodes[key] = node
        self.by_page[page_id] = node
        return node

    def remove(self, node: PrefixNode) -> None:
        """Detach a childless node (placement must already be cleared by the
        allocator or be device-resident-and-released)."""
        if node.children:
            raise ValueError("cannot remove a prefix node with children")
        if node.host_id is not None:
            raise ValueError("cannot remove a node still holding a host slot")
        if node.page_id is not None:
            del self.by_page[node.page_id]
            node.page_id = None
        assert node.parent is not None, "cannot remove the root"
        del node.parent.children[node.key]
        del self.nodes[node.key]
        node.parent = None

    def subtree_postorder(self, node: PrefixNode) -> list[PrefixNode]:
        """Descendants-first (safe removal order), ``node`` last."""
        out: list[PrefixNode] = []

        def walk(n: PrefixNode) -> None:
            for child in list(n.children.values()):
                walk(child)
            out.append(n)

        walk(node)
        return out

    def iter_nodes(self) -> Iterator[PrefixNode]:
        return iter(self.nodes.values())

    # -- placement ----------------------------------------------------------

    def set_device(self, node: PrefixNode, page_id: int) -> None:
        if node.page_id is not None:
            raise ValueError("node already device-resident")
        node.page_id = page_id
        self.by_page[page_id] = node

    def clear_device(self, node: PrefixNode) -> None:
        if node.page_id is None:
            raise ValueError("node not device-resident")
        del self.by_page[node.page_id]
        node.page_id = None

    def set_host(self, node: PrefixNode, host_id: int) -> None:
        if node.host_id is not None:
            raise ValueError("node already host-resident")
        node.host_id = host_id

    def clear_host(self, node: PrefixNode) -> int:
        if node.host_id is None:
            raise ValueError("node not host-resident")
        slot, node.host_id = node.host_id, None
        return slot

    # -- invariants ---------------------------------------------------------

    def check(self) -> None:
        """Structural invariants (the allocator layers the page-state and
        refcount invariants on top): parent links consistent, depths chain,
        every node resident somewhere, by_page exactly inverts page_id."""
        seen_pages: dict[int, bytes] = {}
        for key, node in self.nodes.items():
            assert node.key == key, "node key skew"
            parent = node.parent
            assert parent is not None, "detached node still indexed"
            assert parent is self.root or parent.key in self.nodes, \
                "parent not indexed"
            assert parent.children.get(key) is node, "parent link skew"
            assert node.depth == parent.depth + 1, "depth chain broken"
            assert node.page_id is not None or node.host_id is not None, \
                "node resident nowhere"
            assert node.page_id is None or node.host_id is None, \
                "node resident on BOTH tiers"
            if node.page_id is not None:
                assert node.page_id not in seen_pages, "page mapped twice"
                seen_pages[node.page_id] = key
            assert 0 <= node.last_use <= self.clock, "clock skew"
        assert seen_pages == {p: n.key for p, n in self.by_page.items()}, \
            "by_page index skew"
        assert self.root.page_id is None and self.root.host_id is None

    # -- checkpoint ---------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-safe node list, parents before children (depth order)."""
        records = []
        for node in sorted(self.nodes.values(),
                           key=lambda n: (n.depth, n.key)):
            records.append({
                "key": node.key.hex(),
                "parent": node.parent.key.hex(),
                "depth": node.depth,
                "page": -1 if node.page_id is None else int(node.page_id),
                "host": -1 if node.host_id is None else int(node.host_id),
                "last_use": int(node.last_use),
                "ready": bool(node.ready),
            })
        return {"clock": int(self.clock), "nodes": records}

    def restore_state(self, state: dict) -> None:
        self.root = PrefixNode(b"", None, 0)
        self.nodes, self.by_page = {}, {}
        self.clock = int(state["clock"])
        for rec in state["nodes"]:
            key = bytes.fromhex(rec["key"])
            parent_key = bytes.fromhex(rec["parent"])
            parent = self.root if not parent_key else self.nodes[parent_key]
            node = PrefixNode(key, parent, int(rec["depth"]))
            node.last_use = int(rec["last_use"])
            node.ready = bool(rec.get("ready", True))
            if rec["page"] >= 0:
                node.page_id = int(rec["page"])
                self.by_page[node.page_id] = node
            if rec["host"] >= 0:
                node.host_id = int(rec["host"])
            parent.children[key] = node
            self.nodes[key] = node
        self.check()
