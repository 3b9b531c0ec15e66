"""Host-memory second tier for evicted-but-hot FP8 prefix pages (port of
``repro/serving/tiering.py``).

When the allocator's device-side prefix-cache budget overflows, the LRU
cached page is not dropped: its FP8 page data (content + rope + scale of
every layer) is copied into a slot of this store. A later prompt that
matches the offloaded prefix restores the slot into a fresh device page —
one host-to-device copy per tensor instead of recomputing the page's
prefill.

Division of labor, as in the reference: the ALLOCATOR owns slot placement
(``alloc_slot`` / ``drop``); the ENGINE owns data movement, calling ``store``
(device page -> host copy), ``prefetch`` (start the upload) and ``take`` (the
page payload back on the device, the slot freed).

The tier's ``device`` is the pool's and has no default: a tier for the card
must never be built on the CPU path by omission. On the card (``device`` a
CUDA device):

  * payloads live in pinned host tensors; a pin that fails raises (the tier
    never falls back to pageable memory);
  * every copy, in both directions, runs with ``non_blocking=True`` on the
    tier's own side stream (``HostTier.stream``), so a slot's offload and its
    later upload are ordered by that one stream;
  * ``store`` makes the side stream wait for the compute stream (the page's
    last writes land before it is read) and the compute stream wait for the
    offload's event: the page id is already back on the free list, and the
    next prefill's write into it must not overtake the copy;
  * ``take`` makes the compute stream wait for the upload's event before the
    caller writes the payload into the pool; the pinned source of an upload,
    or of an offload whose slot is dropped, is held until its event is done.

On the CPU the payloads are plain host tensors and nothing is copied
asynchronously; ``prefetch`` copies nothing (it only marks the slot, so the
counters equal the reference's).

The payload is opaque to this class — a list of tuples of tensors (the
engine's: one ``(content, rope, scale)`` tuple of its layers stacked) — so
allocator-level tests can exercise slot accounting with dummy payloads.
``export_state`` encodes it exactly as the reference's does
(tiering.py:37-55): base64 of the bytes, with dtype names in ml_dtypes
spelling (``float8_e4m3fn``, ``bfloat16``), so the two tiers restore each
other's state.
"""
from __future__ import annotations

import base64
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import dtype_name, from_numpy, to_numpy


def _encode(t: torch.Tensor) -> dict:
    a = to_numpy(t)
    return {"dtype": dtype_name(t.dtype), "shape": list(t.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _decode(rec: dict) -> torch.Tensor:
    raw = to_numpy(torch.empty(0, dtype=getattr(torch, rec["dtype"]))).dtype
    a = np.frombuffer(base64.b64decode(rec["data"]), dtype=raw).reshape(rec["shape"])
    return from_numpy(a, rec["dtype"])


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """An empty pinned host tensor shaped like ``t``; raises if it is not
    pinned."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if not out.is_pinned():
        raise RuntimeError("host tier: could not pin a host buffer")
    return out


class HostTier:
    """Slot-addressed host store of offloaded FP8 KV pages."""

    def __init__(self, n_slots: int, device: "str | torch.device"):
        self.n_slots = int(n_slots)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._free: list[int] = list(range(self.n_slots - 1, -1, -1))
        # slot -> list[(content, rope, scale)] host copies
        self._data: dict[int, list[tuple]] = {}
        # slot -> event recorded after the slot's offload copy (card)
        self._stored: dict[int, torch.cuda.Event] = {}
        # slot -> (payload on the device, event after its upload); on the CPU
        # the host payload itself and no event
        self._staged: dict[int, tuple[list[tuple], Any]] = {}
        # (event, host buffers) kept alive until the copy behind the event is done
        self._held: list[tuple[torch.cuda.Event, Any]] = []
        self.offloads = 0
        self.restores = 0
        self.prefetches = 0

    # -- slot accounting (allocator side) -----------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.n_slots - len(self._free)

    def alloc_slot(self) -> int | None:
        """Reserve a slot for a pending offload (data arrives via ``store``
        when the engine drains). None when the tier is full."""
        if not self._free:
            return None
        return self._free.pop()

    def drop(self, slot: int) -> None:
        """Release a slot (host LRU eviction / subtree drop); any stored or
        staged payload is discarded."""
        if slot in self._free or not (0 <= slot < self.n_slots):
            raise ValueError(f"bad host-tier slot {slot}")
        data = self._data.pop(slot, None)
        ev = self._stored.pop(slot, None)
        if ev is not None:
            self._hold(ev, data)
        staged = self._staged.pop(slot, None)
        if staged is not None and staged[1] is not None:
            self._hold(staged[1], data)
        self._free.append(slot)

    # -- data movement (engine side) ----------------------------------------

    def _hold(self, event: torch.cuda.Event, buffers: Any) -> None:
        self._held = [(e, b) for e, b in self._held if not e.query()]
        self._held.append((event, buffers))

    def store(self, slot: int, page_data: list[tuple]) -> None:
        """Copy a device page's payload into a previously reserved slot."""
        if slot in self._free or not (0 <= slot < self.n_slots):
            raise ValueError(f"store into unreserved host-tier slot {slot}")
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(compute)
            for leaf in page_data:
                for t in leaf:
                    t.record_stream(self.stream)    # a staging copy outlives this call
            with torch.cuda.stream(self.stream):
                host = [tuple(_pinned(t).copy_(t, non_blocking=True) for t in leaf)
                        for leaf in page_data]
                ev = torch.cuda.Event()
                ev.record(self.stream)
            compute.wait_event(ev)
            self._stored[slot] = ev
        else:
            host = [tuple(t.to("cpu", copy=True) for t in leaf) for leaf in page_data]
        self._data[slot] = host
        self.offloads += 1

    def has_data(self, slot: int) -> bool:
        return slot in self._data

    def _upload(self, slot: int) -> None:
        host = self._data[slot]
        if not self._cuda:
            self._staged[slot] = (host, None)
            return
        with torch.cuda.stream(self.stream):
            dev = [tuple(t.to(self.device, non_blocking=True) for t in leaf) for leaf in host]
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._staged[slot] = (dev, ev)

    def prefetch(self, slot: int) -> None:
        """Begin the host -> device upload for ``slot`` on the side stream
        without blocking; ``take`` hands the uploaded payload over."""
        if slot in self._staged or slot not in self._data:
            return
        self._upload(slot)
        self.prefetches += 1

    def take(self, slot: int) -> list[tuple]:
        """Consume a slot for restore: the payload on the tier's device (the
        compute stream waits for its upload) and the slot freed."""
        if slot not in self._data:
            raise ValueError(f"take from empty host-tier slot {slot}")
        if slot not in self._staged:
            self._upload(slot)
        payload, ev = self._staged.pop(slot)
        if ev is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ev)
            for leaf in payload:
                for t in leaf:
                    t.record_stream(compute)
            self._hold(ev, self._data[slot])
        del self._data[slot]
        self._stored.pop(slot, None)
        self._free.append(slot)
        self.restores += 1
        return payload

    def synchronize(self) -> None:
        """Wait for every copy the tier started (before its host payloads are
        read, or the pool is snapshotted)."""
        if self._cuda:
            self.stream.synchronize()
            self._held = []

    # -- invariants ---------------------------------------------------------

    def check(self, referenced: set[int], pending: set[int]) -> None:
        """``referenced``: slots held by prefix-tree nodes. ``pending``:
        slots owned by not-yet-drained restore ops. Together they must
        account for every non-free slot exactly once."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free host slot"
        assert free <= set(range(self.n_slots)), "host slot out of range"
        used = set(range(self.n_slots)) - free
        assert not (referenced & pending), \
            "host slot both node-referenced and restore-pending"
        assert referenced | pending == used, \
            f"host-tier slot leak: used={used} referenced={referenced} " \
            f"pending={pending}"
        assert set(self._data) <= used, "payload in a free slot"
        assert set(self._staged) <= set(self._data), "staged without data"

    # -- checkpoint ---------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-safe snapshot including payload bytes (a restore must be able
        to serve them without the original device pages)."""
        self.synchronize()
        data = {str(slot): [[_encode(t) for t in leaf] for leaf in leaves]
                for slot, leaves in self._data.items()}
        return {
            "n_slots": self.n_slots,
            "free": list(self._free),
            "data": data,
            "offloads": self.offloads,
            "restores": self.restores,
            "prefetches": self.prefetches,
        }

    def restore_state(self, state: dict) -> None:
        if int(state["n_slots"]) != self.n_slots:
            raise ValueError(
                f"checkpointed host tier geometry ({state['n_slots']} "
                f"slots) does not match this engine ({self.n_slots})")
        self.synchronize()
        self._free = [int(s) for s in state["free"]]
        self._staged, self._stored = {}, {}
        pin = (lambda t: t.pin_memory()) if self._cuda else (lambda t: t)
        self._data = {
            int(slot): [tuple(pin(_decode(rec)) for rec in leaf) for leaf in leaves]
            for slot, leaves in state["data"].items()}
        self.offloads = int(state["offloads"])
        self.restores = int(state["restores"])
        self.prefetches = int(state["prefetches"])
