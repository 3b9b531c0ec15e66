"""Self-speculative drafting for the serving engine (no second model).

A copy of ``repro/serving/speculative.py`` (the port imports nothing of the JAX package).

The proposer is pure host-side bookkeeping: per-slot, it drafts up to
``draft_len`` candidate continuation tokens by n-gram lookup in the slot's
own history (prompt + committed output) — "prompt lookup decoding". The
engine then verifies every slot's draft in ONE ``verify_step``
dispatch (the q_len>1 split-KV kernel) and commits the longest accepted
prefix; rejected tails are rolled back by rewinding ``seq_lens`` (pages
never move, and the verify block's pool writes past the accepted prefix are
masked by the next step's pushed lengths).

Acceptance-driven adaptation: each slot carries its own ``draft_len``.
Full acceptance grows it (+1, up to the configured maximum); zero
acceptance halves it (down to 1). Repetitive sequences therefore climb to
long drafts while incompressible ones degrade to plain decode (a draft of
length 0 when no n-gram match exists costs nothing — the verify block then
carries only the slot's last committed token, i.e. an ordinary decode row).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _SlotState:
    draft_len: int
    drafted: int = 0
    accepted: int = 0


@dataclass
class NgramProposer:
    """Per-slot n-gram draft proposer with acceptance-adaptive lengths.

    ``max_ngram`` is the longest history suffix matched against (falls back
    to shorter suffixes down to ``min_ngram``); ``max_draft_len`` caps the
    adaptive per-slot budget."""

    max_draft_len: int
    max_ngram: int = 4
    min_ngram: int = 1
    _slots: dict[str, _SlotState] = field(default_factory=dict)

    # -- drafting ----------------------------------------------------------

    def _slot(self, rid: str) -> _SlotState:
        if rid not in self._slots:
            self._slots[rid] = _SlotState(draft_len=max(1, self.max_draft_len))
        return self._slots[rid]

    def propose(self, rid: str, context: list[int],
                budget: int | None = None) -> list[int]:
        """Draft up to min(slot draft_len, budget) tokens continuing
        ``context`` (the slot's prompt + committed output). Returns [] when
        no suffix of length >= min_ngram recurs earlier in the context."""
        st = self._slot(rid)
        limit = st.draft_len if budget is None else min(st.draft_len, budget)
        if limit <= 0 or len(context) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(context) - 1),
                       self.min_ngram - 1, -1):
            suffix = context[-n:]
            # most recent earlier occurrence of the suffix (rfind semantics)
            for i in range(len(context) - n - 1, -1, -1):
                if context[i:i + n] == suffix:
                    draft = context[i + n:i + n + limit]
                    if draft:
                        return list(draft)
                    break
        return []

    # -- adaptation --------------------------------------------------------

    def observe(self, rid: str, drafted: int, accepted: int) -> None:
        """Fold one verify outcome into the slot's adaptive draft length:
        full acceptance -> +1 (cap max_draft_len), zero acceptance on a
        non-empty draft -> halve (floor 1)."""
        st = self._slot(rid)
        st.drafted += drafted
        st.accepted += accepted
        if drafted == 0:
            return
        if accepted >= drafted:
            st.draft_len = min(self.max_draft_len, st.draft_len + 1)
        elif accepted == 0:
            st.draft_len = max(1, st.draft_len // 2)

    def drop(self, rid: str) -> None:
        """Forget a slot (retire / fail / requeue — a requeued request
        restarts with a fresh adaptive state)."""
        self._slots.pop(rid, None)

    def draft_len(self, rid: str) -> int:
        return self._slot(rid).draft_len

    # -- checkpointing -----------------------------------------------------

    def export_state(self) -> dict:
        return {rid: {"draft_len": s.draft_len, "drafted": s.drafted,
                      "accepted": s.accepted}
                for rid, s in self._slots.items()}

    def restore_state(self, state: dict) -> None:
        self._slots = {
            rid: _SlotState(draft_len=int(v["draft_len"]),
                            drafted=int(v.get("drafted", 0)),
                            accepted=int(v.get("accepted", 0)))
            for rid, v in (state or {}).items()}
