"""Continuous-batching serving engine over the shared FP8 paged pool (port of
``repro/serving/engine.py``).

The engine drives the port's steps (``steps.make_prefill_step`` /
``make_chunked_prefill_step`` / ``make_decode_step`` / ``make_verify_step``)
over a dynamic request population: a fixed ``max_batch`` slot array over one
shared pool, idle and still-prefilling slots parked on the allocator's
scratch page; chunked admission (``ModelConfig.prefill_chunk``) with a
per-step token budget, chunk widths bucketed to powers of two, later chunks
reading earlier ones back from the FP8 pool through the fused fetch-dequant
kernel; refcounted prefix sharing with the radix prefix cache; evict-to-
requeue under pool pressure; self-speculative decoding (``spec_draft_len``)
verified by the q_len > 1 split-KV kernel; the per-slot NaN quarantine with
one retry on the plain reference backend; deadlines and a bounded queue.
Greedy output is token-identical to the static-batch ``serve.generate``
oracle on the same backend family.

Not ported yet (the engine raises ``ValueError`` naming the module when
asked): the host tier (``tiering.py``, ``host_tier_pages``), snapshot /
restore (``checkpoint/``, ``runtime/fault_tolerance.py``), the span tracer
(``obs/trace.py``) and the quant-health probe (``obs/quant_health.py``,
``quant_health_every``).

How the JAX-only mechanisms of the reference map onto PyTorch:

  * *Donation* (``donate_argnums``): the port's pool writes are already in
    place (``index_put_``), so the state a step returns shares its page
    tensors with the engine's own; a prefill step's returned state is
    dropped (the engine keeps its host-owned tables), a decode step's is
    adopted by assignment.
  * *The prefill trace counter* (``_counted``, engine.py:265-272, which
    counts jit traces): the port counts the distinct input shapes each
    prefill function is dispatched with — one per padded chunk width for
    chunked prefill, one per (group size, prompt length) for the monolithic
    one — which is what the reference's jit retraces on, so ``serve``'s
    check that the chunked count stays within the bucket count keeps its
    meaning.
  * *``fold_in(key, count)`` sampling keys*: one ``torch.Generator`` per
    (seed, rid, count), seeded from a hash of the three. A request's draws
    depend only on its own id and token index, so sampled runs are
    reproducible per seed whatever they are co-batched with, and sampled
    speculative output equals sampled sequential output. The draws are not
    JAX's: the generators differ.
  * *One host transfer per step*: tokens and per-row finite flags are
    computed on the device and copied back together.
  * *Warm-up*: ``__init__`` dispatches one decode step (and one verify step
    when speculating) on the all-idle state, so a kernel library that fails
    to build or load raises there.
  * *Degradation*: the reference reruns any decode or verify dispatch that
    raises on its reference backend. The port does so only for a raise the
    ``FaultPlan`` injects, or on CPU tensors (where every wrapper already
    runs its plain version); on the card a raise propagates.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvcache import page_aligned_capacity, pool_with_tables
from repro_torch.kernels.mla_decode import backends as BK
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.allocator import PageAllocator
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.scheduler import Request, Scheduler, Status
from repro_torch.serving.speculative import NgramProposer

# the typed fault/degradation events the engine counts (the reference's set;
# "preemptions" and "restores" stay 0 until snapshot/restore is ported)
FAULT_KINDS = (
    "nonfinite_rows",        # quarantined decode rows seen
    "recovered_ref",         # ..recovered by the reference-backend retry
    "failed_nonfinite",      # ..terminal (retry also non-finite)
    "failed_prefill",        # non-finite prefill logits
    "backend_faults",        # decode dispatch raised
    "ref_fallback_steps",    # steps degraded to the reference backend
    "deadline_cancelled",    # typed FAILED("deadline")
    "rejected",              # bounded-queue load shedding
    "preemptions",
    "restores",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Host-side engine knobs (the model itself comes from ModelConfig); the
    reference's fields, with ``host_tier_pages`` and ``quant_health_every``
    refused until their modules are ported."""

    max_batch: int = 4             # decode slot count
    n_pages: int = 0               # physical pool pages (0 = max_batch full spans + scratch)
    max_pages_per_seq: int = 8     # page-table width (max context in pages)
    prefix_sharing: bool = True
    prefix_cache_pages: int = 0    # radix cache: refcount-0 prefix pages retained (LRU)
    host_tier_pages: int = 0       # not ported (tiering.py)
    prefill_budget: int = 0        # chunked-prefill tokens per step (0 = one pass)
    max_queue: int = 0             # bounded admission queue (0 = unbounded)
    ref_retry: bool = True         # quarantined row: one retry on the reference backend
    quant_health_every: int = 0    # not ported (obs/quant_health.py)
    spec_draft_len: int = 0        # self-speculative draft tokens per slot (0 = off)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int | None = None
    seed: int = 0

    def resolved_n_pages(self) -> int:
        if self.n_pages:
            return self.n_pages
        return self.max_batch * self.max_pages_per_seq + 1   # + scratch page


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str                    # "done" | "failed" | "rejected"
    tokens: list[int]              # full output, or partial for FAILED
    prompt_len: int
    ttft_steps: int                # first token step - arrival (virtual)
    latency_steps: int             # finish step - arrival (virtual)
    ttft_work: int                 # work units (tokens) arrival -> first token
    requeues: int                  # evict-to-requeue round trips
    ttft_s: float                  # wall-clock first-token latency
    latency_s: float               # wall-clock total latency
    fail_reason: str = ""


def sample_seed(seed: int, rid: int, count: int) -> int:
    """The generator seed of token ``count`` of request ``rid``."""
    digest = hashlib.sha256(f"{seed}:{rid}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class ServingEngine:
    """Admit → (chunked) prefill → decode or verify → retire over one pool."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 fault_plan: FaultPlan | None = None, tracer: Any = None,
                 device: "str | torch.device | None" = None):
        if cfg.layer_pattern != ("mla",) or cfg.mla is None:
            raise ValueError("the serving engine drives the paged MLA decode path; "
                             f"layer pattern {cfg.layer_pattern} is not pure-MLA")
        if cfg.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        for field, module in (("host_tier_pages", "serving/tiering.py"),
                              ("quant_health_every", "obs/quant_health.py")):
            if getattr(ecfg, field):
                raise ValueError(f"EngineConfig.{field} needs {module}, which is not "
                                 "ported yet")
        if tracer is not None:
            raise ValueError("the span tracer (obs/trace.py) is not ported yet")
        self.ecfg = ecfg
        self.device = torch.device(device) if device is not None \
            else params["embed"].device
        self.page = cfg.page_size
        self.chunk = cfg.prefill_chunk
        self.span_pages = ecfg.max_pages_per_seq
        self.n_pages = ecfg.resolved_n_pages()
        self.cfg = dataclasses.replace(cfg, kv_paged=True, kv_pool_pages=self.n_pages)
        self.params = params
        self.state = T.init_decode_state(self.cfg, ecfg.max_batch,
                                         self.span_pages * self.page, device=self.device)

        self.registry = MetricsRegistry()
        self._register_metrics()
        self._prefill_shapes: set = set()   # distinct prefill input shapes dispatched

        self._prefill_fn = ST.make_prefill_step(self.cfg)
        self._chunk_fn = ST.make_chunked_prefill_step(self.cfg)
        self._decode_fn = ST.make_decode_step(self.cfg)
        self._ref_fn = ST.make_ref_decode_step(self.cfg)
        self.proposer = (NgramProposer(max_draft_len=ecfg.spec_draft_len)
                         if ecfg.spec_draft_len > 0 else None)
        self._verify_fn = ST.make_verify_step(self.cfg) if self.proposer else None
        self._ref_verify_fn = ST.make_verify_step(self.cfg, ref=True)

        self.allocator = PageAllocator(
            self.n_pages, self.page, prefix_sharing=ecfg.prefix_sharing,
            prefix_cache_pages=ecfg.prefix_cache_pages, host_tier=None)
        self.scheduler = Scheduler(ecfg.max_batch, max_queue=ecfg.max_queue)
        self.table = np.zeros((ecfg.max_batch, self.span_pages), np.int32)
        self.last_tok = np.zeros((ecfg.max_batch,), np.int32)

        # warm-up on the all-idle state (every slot on the scratch page),
        # outside the degradation path: the kernels build and launch here
        idle = np.zeros((ecfg.max_batch,), np.int32)
        _, self.state = self._decode_fn(
            self.params, self._dev(idle), self._state_with_tables(self.table, idle),
            self._dev(idle))
        if self.proposer is not None:
            K = ecfg.spec_draft_len + 1
            _, self.state = self._verify_fn(
                self.params, self._dev(np.zeros((ecfg.max_batch, K), np.int32)),
                self._state_with_tables(self.table, idle), self._dev(idle))
        self._sync()

        self.step_idx = 0
        self.prefill_tokens_series: list[int] = []
        self.stall_tokens_series: list[int] = []
        self.util_series: list[float] = []
        self._wall: dict[int, dict[str, float]] = {}
        self.registry.register_collector(self._collect_occupancy)
        self._backend = BK.resolve_backend(cfg.decode_backend, paged=True,
                                           use_kernels=cfg.use_kernels)
        self.fault_plan = fault_plan
        self._seen_rids: set[int] = set()

    # ------------------------------------------------------------------
    # telemetry (obs/metrics registry + attribute views)
    # ------------------------------------------------------------------

    def _register_metrics(self) -> None:
        r = self.registry
        self._c_steps = r.counter("snapmla_engine_steps_total", "engine steps executed")
        self._c_decode_tokens = r.counter("snapmla_engine_decode_tokens_total",
                                          "tokens produced by decode steps")
        self._c_prefill_tokens = r.counter("snapmla_engine_prefill_tokens_total",
                                           "padded chunk/prompt tokens processed")
        self._c_prefill_skipped = r.counter("snapmla_engine_prefill_skipped_tokens_total",
                                            "prefill tokens avoided by prefix-cache hits")
        self._c_work = r.counter("snapmla_engine_work_units_total",
                                 "total work units (tokens) processed")
        self._c_evictions = r.counter("snapmla_engine_evictions_total",
                                      "pressure evictions (evict-to-requeue round trips)")
        self._c_prefill_traces = r.counter("snapmla_engine_prefill_traces_total",
                                           "distinct prefill input shapes dispatched")
        self._h_chunk_width = r.histogram("snapmla_engine_prefill_chunk_width",
                                          "padded token width of each prefill dispatch")
        self._c_fetch_bounded = r.counter("snapmla_fetch_pages_bounded_total",
                                          "chunk-prefill pages read (bounded prefix fetch)")
        self._c_fetch_full = r.counter("snapmla_fetch_pages_full_total",
                                       "pages a full-span fetch would have read")
        self._c_blocks_visited = r.counter("snapmla_fetch_decode_blocks_visited_total",
                                           "KV blocks decode visits (seq_lens early exit)")
        self._c_blocks_full = r.counter("snapmla_fetch_decode_blocks_full_total",
                                        "KV blocks a dense decode sweep would visit")
        self._c_roof_bytes = r.counter("snapmla_roofline_model_bytes_total",
                                       "modeled HBM bytes moved by the resolved decode backend")
        self._c_roof_bytes_min = r.counter("snapmla_roofline_bytes_min_total",
                                           "compulsory HBM bytes (visited tokens only)")
        self._c_roof_flops = r.counter("snapmla_roofline_flops_total", "modeled attention FLOPs")
        self._g_roof_frac = r.gauge("snapmla_roofline_achieved_fraction",
                                    "bytes_min / modeled bytes for the last decode dispatch")
        self._c_spec_steps = r.counter("snapmla_spec_verify_steps_total",
                                       "speculative verify dispatches")
        self._c_spec_slot_steps = r.counter("snapmla_spec_slot_steps_total",
                                            "per-slot verify rows dispatched")
        self._c_spec_drafted = r.counter("snapmla_spec_drafted_tokens_total",
                                         "draft tokens proposed for verification")
        self._c_spec_accepted = r.counter("snapmla_spec_accepted_tokens_total",
                                          "draft tokens accepted by the longest-prefix rule")
        self._g_spec_accept_rate = r.gauge("snapmla_spec_accept_rate",
                                           "cumulative accepted/drafted draft-token ratio")
        self._c_faults = r.counter("snapmla_engine_faults_total",
                                   "fault-tolerance events by kind", labels=("kind",))
        for kind in FAULT_KINDS:
            self._c_faults.labels(kind=kind)
        self._w_decode_s = r.counter("snapmla_wall_decode_seconds_total",
                                     "wall seconds inside decode dispatch", wall=True)
        self._w_prefill_s = r.counter("snapmla_wall_prefill_seconds_total",
                                      "wall seconds inside prefill dispatch", wall=True)
        self._w_stall_s = r.counter("snapmla_wall_stall_seconds_total",
                                    "wall seconds prefilling while decodes waited", wall=True)
        self._g_pages_in_use = r.gauge("snapmla_pages_in_use",
                                       "pool pages referenced by live requests")
        self._g_pages_free = r.gauge("snapmla_pages_free", "pool pages on the free list")
        self._g_pages_cached = r.gauge("snapmla_pages_cached", "refcount-0 cache-retained pages")
        self._g_pages_peak_in_use = r.gauge("snapmla_pages_peak_in_use",
                                            "high-water mark of in-use pages")
        self._g_pages_peak_resident = r.gauge("snapmla_pages_peak_resident",
                                              "high-water mark of in-use + cached pages")
        self._g_cache_saved = r.gauge("snapmla_cache_saved_pages",
                                      "pages avoided via prefix sharing (live-hit)")
        self._g_cache_reused = r.gauge("snapmla_cache_reused_pages",
                                       "pages re-adopted from the refcount-0 cache")
        self._g_cache_dropped = r.gauge("snapmla_cache_dropped_pages",
                                        "cached pages dropped under pressure")
        self._g_sched_requeues = r.gauge("snapmla_sched_requeues",
                                         "cumulative evict-to-requeue count")
        self._g_sched_active = r.gauge("snapmla_sched_active_slots",
                                       "requests in prefill/decode slots")

    def _collect_occupancy(self) -> None:
        a = self.allocator
        self._g_pages_in_use.set(a.num_in_use)
        self._g_pages_free.set(a.num_free)
        self._g_pages_cached.set(a.num_cached)
        self._g_pages_peak_in_use.set(a.peak_in_use)
        self._g_pages_peak_resident.set(a.peak_resident)
        self._g_cache_saved.set(a.pages_saved_by_sharing)
        self._g_cache_reused.set(a.pages_reused_cached)
        self._g_cache_dropped.set(a.cache_drops)
        self._g_sched_requeues.set(self.scheduler.requeues)
        self._g_sched_active.set(self.scheduler.num_active)

    def _fault(self, kind: str, n: int = 1) -> None:
        self._c_faults.labels(kind=kind).inc(n)

    def telemetry(self, *, include_wall: bool = False) -> dict:
        return self.registry.snapshot(include_wall=include_wall)

    @property
    def decode_tokens(self) -> int:
        return self._c_decode_tokens.value

    @property
    def prefill_tokens(self) -> int:
        return self._c_prefill_tokens.value

    @property
    def prefill_skipped_tokens(self) -> int:
        return self._c_prefill_skipped.value

    @property
    def work_done(self) -> int:
        return self._c_work.value

    @property
    def evictions(self) -> int:
        return self._c_evictions.value

    @property
    def prefill_traces(self) -> int:
        return self._c_prefill_traces.value

    @property
    def spec_drafted_tokens(self) -> int:
        return self._c_spec_drafted.value

    @property
    def spec_accepted_tokens(self) -> int:
        return self._c_spec_accepted.value

    @property
    def decode_seconds(self) -> float:
        return self._w_decode_s.value

    @property
    def prefill_seconds(self) -> float:
        return self._w_prefill_s.value

    @property
    def stall_seconds(self) -> float:
        return self._w_stall_s.value

    @property
    def faults(self) -> dict[str, int]:
        return {k: self._c_faults.labels(kind=k).value for k in FAULT_KINDS}

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def required_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case private pages a request can hold (the final sampled
        token is never appended)."""
        return page_aligned_capacity(prompt_len + max_new - 1, self.page) // self.page

    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        need = self.required_pages(req.prompt_len, req.max_new)
        if need > self.span_pages:
            raise ValueError(
                f"request {req.rid}: {need} pages exceed the page-table width "
                f"{self.span_pages} (prompt {req.prompt_len} + {req.max_new} new tokens)")
        if need > self.allocator.capacity:
            raise ValueError(f"request {req.rid}: {need} pages exceed pool capacity "
                             f"{self.allocator.capacity}")
        self._wall[req.rid] = {"arrival": time.time()}
        req.arrival_work = self.work_done
        self._seen_rids.add(req.rid)
        if self.scheduler.queue_full:
            self._fault("rejected")
            self._wall[req.rid]["finish"] = time.time()
            self.scheduler.reject(req, self.step_idx, "queue_full")
            return
        self.scheduler.submit(req)

    # ------------------------------------------------------------------
    # state plumbing (host tables -> the pools)
    # ------------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state_with_tables(self, table: np.ndarray, seq_lens: np.ndarray):
        """Every layer's pool with the host table and lengths (copied to the
        device once and shared by the layers)."""
        t, s = self._dev(table.astype(np.int32)), self._dev(seq_lens.astype(np.int32))
        return {**self.state,
                "layers": [pool_with_tables(p, t, s) for p in self.state["layers"]]}

    def _count_prefill_shape(self, kind: str, shape: tuple) -> None:
        if (kind, shape) not in self._prefill_shapes:
            self._prefill_shapes.add((kind, shape))
            self._c_prefill_traces.inc()

    # ------------------------------------------------------------------
    # sampling + host sync (one transfer per call)
    # ------------------------------------------------------------------

    def _postprocess(self, rows: torch.Tensor, reqs: list[Request],
                     counts: list[int] | None = None):
        """``rows`` [n, V] aligned with ``reqs`` -> (tokens [n], finite [n])
        as numpy, from one device-to-host copy. Sampled draws use one
        generator per (seed, rid, count); ``counts`` overrides the token
        index (the verify passes one row per candidate position)."""
        e = self.ecfg
        finite = torch.all(torch.isfinite(rows), dim=-1)
        if e.temperature <= 0.0:
            toks = torch.argmax(rows, dim=-1).to(torch.int32)
        else:
            if counts is None:
                counts = [len(r.out_tokens) for r in reqs]
            probs = torch.softmax(ST.masked_logits(rows, e.temperature, e.top_k, e.top_p),
                                  dim=-1)
            picks = []
            for i, (r, c) in enumerate(zip(reqs, counts)):
                g = torch.Generator(device=rows.device)
                g.manual_seed(sample_seed(e.seed, r.rid, c))
                picks.append(torch.multinomial(probs[i:i + 1], 1, generator=g)[0, 0])
            toks = torch.stack(picks).to(torch.int32)
        both = torch.stack([toks, finite.to(torch.int32)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _emit(self, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        self.last_tok[req.slot] = tok
        if len(req.out_tokens) == 1:
            req.first_token_step = self.step_idx
            req.first_token_work = self.work_done
            self._wall[req.rid]["first"] = time.time()
        eos_hit = self.ecfg.eos_id is not None and tok == self.ecfg.eos_id
        if len(req.out_tokens) >= req.max_new or eos_hit:
            self._retire(req)

    def _drop_spec_state(self, req: Request) -> None:
        if self.proposer is not None:
            self.proposer.drop(str(req.rid))

    def _park(self, slot: int) -> None:
        if slot >= 0:
            self.table[slot] = 0          # the slot back on the scratch page
            self.last_tok[slot] = 0

    def _retire(self, req: Request) -> None:
        slot = req.slot
        self._drop_spec_state(req)
        self.scheduler.retire(req, self.step_idx, self.allocator)
        self._wall[req.rid]["finish"] = time.time()
        self._park(slot)

    def _requeue(self, req: Request) -> None:
        """Evict-to-requeue: pages freed, generated tokens kept; the request
        replays prompt + generated tokens at its next admission."""
        slot = req.slot
        self._drop_spec_state(req)
        self.scheduler.requeue(req, self.allocator)
        self._park(slot)

    def _fail(self, req: Request, reason: str) -> None:
        slot = req.slot
        self._drop_spec_state(req)
        self.scheduler.fail(req, self.step_idx, self.allocator, reason)
        self._wall.setdefault(req.rid, {"arrival": time.time()})
        self._wall[req.rid]["finish"] = time.time()
        self._park(slot)

    def _sweep_deadlines(self) -> None:
        now = self.step_idx
        stale = [r for r in list(self.scheduler.queue) + self.scheduler.active
                 if r.status in (Status.QUEUED, Status.PREFILLING)
                 and r.any_deadline_blown(now)]
        for req in stale:
            self._fault("deadline_cancelled")
            self._fail(req, "deadline")

    # ------------------------------------------------------------------
    # degraded decode paths: quarantine retry + fallback
    # ------------------------------------------------------------------

    def _retry_ref(self, req: Request) -> tuple[bool, int]:
        """Re-run THIS slot's decode step on the reference backend against
        the pre-step view (the append rewrites the same position) and
        re-postprocess: (recovered?, token)."""
        slot = req.slot
        table_view = np.zeros_like(self.table)
        table_view[slot] = self.table[slot]
        seq_lens = np.zeros((self.ecfg.max_batch,), np.int32)
        seq_lens[slot] = req.seq_len
        view = self._state_with_tables(table_view, seq_lens)
        logits, _ = self._ref_fn(self.params, self._dev(self.last_tok), view,
                                 self._dev(seq_lens))
        row = logits[slot][None].clone()
        if self.fault_plan and self.fault_plan.retry_poisoned(self.step_idx, slot):
            row[0, 0] = float("nan")          # sticky fault: the input diverges
        toks, finite = self._postprocess(row, [req])
        return bool(finite[0]), int(toks[0])

    def _quarantine(self, req: Request) -> None:
        self._fault("nonfinite_rows")
        if self.ecfg.ref_retry:
            recovered, tok = self._retry_ref(req)
            if recovered:
                self._fault("recovered_ref")
                self._emit(req, tok)
                return
        self._fault("failed_nonfinite")
        self._fail(req, "nonfinite")

    # ------------------------------------------------------------------
    # admission + prefill (monolithic OR chunked)
    # ------------------------------------------------------------------

    def _admit(self) -> list[Request]:
        admitted = self.scheduler.admit(self.allocator, self.step_idx)
        for r in admitted:
            row = np.zeros((self.span_pages,), np.int32)
            row[:len(r.pages)] = r.pages
            self.table[r.slot] = row
        for r in admitted:
            if self.chunk <= 0 or r.cached_tokens <= 0:
                continue
            # radix-cache hit: the chunk cursor starts after the matched pages
            eff_len = len(r.effective_prompt)
            if r.out_tokens:
                r.prefill_pos = min(r.cached_tokens, eff_len)
            else:
                r.prefill_pos = min(r.cached_tokens, eff_len - 1)
            self._c_prefill_skipped.inc(r.prefill_pos)
            if r.prefill_pos >= eff_len:
                self._finish_prefill(r, None)
        return admitted

    def _finish_prefill(self, req: Request, logits_row) -> None:
        """Replayed requests resume from their pending last token; fresh ones
        sample their first token from the final chunk's logits."""
        req.status = Status.DECODE
        if req.out_tokens:
            self.last_tok[req.slot] = req.out_tokens[-1]
            return
        toks, finite = self._postprocess(logits_row, [req])
        if not finite[0]:
            self._fault("failed_prefill")
            self._fail(req, "nonfinite_prefill")
            return
        self._emit(req, int(toks[0]))

    def _run_chunk(self, req: Request) -> int:
        """One bucketed chunk of ``req``'s (effective) prompt; returns the
        work units spent (the padded width)."""
        eff = req.effective_prompt
        width = min(self.chunk, len(eff) - req.prefill_pos)
        bucket = ST.bucket_for(width, self.chunk)
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :width] = eff[req.prefill_pos:req.prefill_pos + width]
        view = self._state_with_tables(self.table[req.slot][None],
                                       np.asarray([req.prefill_pos], np.int32))
        self._count_prefill_shape("chunk", tok.shape)
        t0 = time.time()
        logits, _ = self._chunk_fn(
            self.params, self._dev(tok).long(), view,
            self._dev(np.asarray([req.prefill_pos], np.int32)),
            self._dev(np.asarray([width - 1], np.int32)))
        self._sync()
        self._w_prefill_s.inc(time.time() - t0)
        self._c_fetch_bounded.inc(-(-req.prefill_pos // self.page))
        self._c_fetch_full.inc(self.span_pages)
        self._h_chunk_width.observe(bucket)
        req.prefill_pos += width
        self.allocator.mark_ready(req.pages, req.prefill_pos)
        if req.prefill_pos == len(eff):
            self._finish_prefill(req, logits)
        return bucket

    def _prefill_chunked(self) -> int:
        """FCFS round-robin passes over the PREFILLING requests, one chunk
        each, until the step's token budget is spent (0 = one pass); the head
        always gets one chunk."""
        budget = self.ecfg.prefill_budget
        spent = 0
        while True:
            reqs = self.scheduler.prefilling
            if not reqs:
                break
            for req in reqs:
                if budget > 0 and spent and spent >= budget:
                    return spent
                spent += self._run_chunk(req)
            if budget <= 0:
                break
        return spent

    def _prefill_monolithic(self, admitted: list[Request]) -> int:
        """One-shot prefill of this step's admissions, batched by (effective)
        prompt length."""
        by_len: dict[int, list[Request]] = {}
        for r in admitted:
            by_len.setdefault(len(r.effective_prompt), []).append(r)
        spent = 0
        for length, group in by_len.items():
            rows = np.stack([self.table[r.slot] for r in group])
            prompts = np.stack([r.effective_prompt for r in group]).astype(np.int32)
            view = self._state_with_tables(rows, np.zeros((len(group),), np.int32))
            self._count_prefill_shape("prompt", prompts.shape)
            t0 = time.time()
            logits, _ = self._prefill_fn(self.params, self._dev(prompts).long(), view)
            self._sync()
            self._w_prefill_s.inc(time.time() - t0)
            self._h_chunk_width.observe(length)
            for r in group:
                self.allocator.mark_ready(r.pages, length)
            fresh = [r for r in group if not r.out_tokens]
            for r in group:
                if r.out_tokens:                  # replay after requeue
                    r.status = Status.DECODE
                    self.last_tok[r.slot] = r.out_tokens[-1]
            if fresh:
                idx = torch.as_tensor([group.index(r) for r in fresh], device=logits.device)
                toks, finite = self._postprocess(logits[idx], fresh)
                for r, tok, ok in zip(fresh, toks, finite):
                    if not ok:
                        self._fault("failed_prefill")
                        self._fail(r, "nonfinite_prefill")
                        continue
                    r.status = Status.DECODE
                    self._emit(r, int(tok))
            spent += length * len(group)
        return spent

    # ------------------------------------------------------------------
    # growth / eviction
    # ------------------------------------------------------------------

    def _ensure_capacity(self) -> None:
        """Every decoding request gets a page slot for the token this step
        appends: grow by one page, else evict (a blown-deadline victim is
        cancelled, otherwise the youngest is requeued). Speculating slots
        grow toward room for their draft but never evict for it."""
        forced = bool(self.fault_plan and self.fault_plan.alloc_fail(self.step_idx))
        for req in list(self.scheduler.active):
            if req.status is not Status.DECODE:
                continue
            while req.seq_len >= len(req.pages) * self.page:
                assert len(req.pages) < self.span_pages, \
                    "submit() validation bounds the page run"
                grown = None if forced else self.allocator.grow(1)
                if grown is not None:
                    req.pages.extend(grown)
                    self.table[req.slot, len(req.pages) - 1] = grown[0]
                    continue
                victim = self.scheduler.eviction_victim(self.step_idx)
                if victim is None:
                    break
                self._c_evictions.inc()
                if victim.any_deadline_blown(self.step_idx):
                    self._fault("deadline_cancelled")
                    self._fail(victim, "deadline")
                else:
                    self._requeue(victim)
                if victim is req:
                    break
                if forced and victim is not req:
                    forced = False
            if self.proposer is None or req.status is not Status.DECODE:
                continue
            want = min(self.proposer.draft_len(str(req.rid)),
                       req.max_new - len(req.out_tokens) - 1)
            while (want > 0 and len(req.pages) < self.span_pages
                   and req.seq_len + want + 1 > len(req.pages) * self.page):
                grown = None if forced else self.allocator.grow(1)
                if grown is None:
                    break
                req.pages.extend(grown)
                self.table[req.slot, len(req.pages) - 1] = grown[0]

    # ------------------------------------------------------------------
    # the step loop
    # ------------------------------------------------------------------

    def _degrade(self, primary, fallback, *args):
        """Run ``primary``, degraded to the reference backend ``fallback``
        (counted as backend_faults and ref_fallback_steps) when the fault plan
        injects a raise at this step, or when ``primary`` raises on CPU
        tensors. On the card a raise propagates: a kernel that fails to
        launch is never hidden behind its plain version."""
        if self.fault_plan and self.fault_plan.backend_raise(self.step_idx):
            self._fault("backend_faults")
            self._fault("ref_fallback_steps")
            return fallback(self.params, *args)
        try:
            return primary(self.params, *args)
        except Exception:
            if self.device.type != "cpu":
                raise
            self._fault("backend_faults")
            self._fault("ref_fallback_steps")
            return fallback(self.params, *args)

    def _dispatch_decode(self, state, seq_lens: np.ndarray):
        """The primary decode dispatch, degraded as ``_degrade`` says."""
        return self._degrade(self._decode_fn, self._ref_fn,
                             self._dev(self.last_tok), state, self._dev(seq_lens))

    def _dispatch_verify(self, state, tokens: np.ndarray, starts: np.ndarray):
        """The verify dispatch, degraded as ``_degrade`` says."""
        return self._degrade(self._verify_fn, self._ref_verify_fn,
                             self._dev(tokens), state, self._dev(starts))

    def _note_cost(self, tokens_visited: int, tokens_full: int) -> None:
        cost = BK.dispatch_cost(
            self._backend, tokens_visited=tokens_visited, tokens_full=tokens_full,
            heads=self.cfg.n_heads, d_c=self.cfg.mla.d_c, d_r=self.cfg.mla.d_rope,
            fmt=self.cfg.kv_fmt)
        self._c_roof_bytes.inc(cost["bytes"])
        self._c_roof_bytes_min.inc(cost["bytes_min"])
        self._c_roof_flops.inc(cost["flops"])
        self._g_roof_frac.set(cost["achieved_fraction"])

    def _spec_decode(self, active: list[Request]) -> None:
        """Self-speculative step: draft (host n-gram lookup), verify every
        slot's draft in ONE q_len = spec_draft_len + 1 dispatch, commit the
        longest accepted prefix; rejected entries are masked by the next
        step's ``seq_lens``. Row t of a slot samples with the token index a
        sequential decode would use."""
        e = self.ecfg
        K = e.spec_draft_len + 1
        tokens = np.zeros((e.max_batch, K), np.int32)
        starts = np.zeros((e.max_batch,), np.int32)
        table_view = np.zeros_like(self.table)
        drafts: dict[int, list[int]] = {}
        for r in active:
            budget = min(e.spec_draft_len, r.max_new - len(r.out_tokens) - 1,
                         len(r.pages) * self.page - r.seq_len - 1)
            d: list[int] = []
            if budget > 0:
                ctx = [int(t) for t in r.prompt] + list(r.out_tokens)
                d = self.proposer.propose(str(r.rid), ctx, budget)
            drafts[r.rid] = d
            row = [int(self.last_tok[r.slot])] + d
            tokens[r.slot, :len(row)] = row
            starts[r.slot] = r.seq_len
            table_view[r.slot] = self.table[r.slot]
        state = self._state_with_tables(table_view, starts)
        t0 = time.time()
        logits, self.state = self._dispatch_verify(state, tokens, starts)
        if self.fault_plan:
            live = {r.slot for r in active}
            for ev in self.fault_plan.nan_slots(self.step_idx):
                if ev.slot in live:
                    self.fault_plan._log(self.step_idx, "nan_logits", ev.slot)
                    logits = logits.clone()
                    logits[ev.slot, 0, 0] = float("nan")
        flat_reqs: list[Request] = []
        flat_counts: list[int] = []
        sel_slots: list[int] = []
        sel_pos: list[int] = []
        for r in active:
            for t in range(len(drafts[r.rid]) + 1):
                flat_reqs.append(r)
                flat_counts.append(len(r.out_tokens) + t)
                sel_slots.append(r.slot)
                sel_pos.append(t)
        dev = logits.device
        rows = logits[torch.as_tensor(sel_slots, device=dev), torch.as_tensor(sel_pos, device=dev)]
        toks, finite = self._postprocess(rows, flat_reqs, counts=flat_counts)
        self._w_decode_s.inc(time.time() - t0)

        self._c_blocks_visited.inc(int(sum(-(-(r.seq_len + t + 1) // self.page)
                                           for r in active for t in range(K))))
        self._c_blocks_full.inc(len(active) * K * self.span_pages)
        self._note_cost(sum(r.seq_len + t + 1 for r in active for t in range(K)),
                        len(active) * K * self.span_pages * self.page)

        idx = 0
        n_drafted = n_accepted = n_emitted = 0
        for r in active:
            d = drafts[r.rid]
            v = len(d)
            committed = 0
            bad = False
            for j in range(v + 1):
                fi = idx + j
                if not finite[fi]:
                    bad = True
                    break
                tok = int(toks[fi])
                self._emit(r, tok)
                n_emitted += 1
                committed += 1
                if r.status is not Status.DECODE:
                    break
                if j < v and tok == d[j]:
                    continue
                break
            idx += v + 1
            accepted = max(committed - 1, 0)
            n_drafted += v
            n_accepted += accepted
            if bad:
                self._quarantine(r)
            elif r.status is Status.DECODE:
                self.proposer.observe(str(r.rid), v, accepted)

        self._c_decode_tokens.inc(n_emitted)
        self._c_work.inc(n_emitted)
        self._c_spec_steps.inc()
        self._c_spec_slot_steps.inc(len(active))
        self._c_spec_drafted.inc(n_drafted)
        self._c_spec_accepted.inc(n_accepted)
        drafted_total = self._c_spec_drafted.value
        self._g_spec_accept_rate.set(
            self._c_spec_accepted.value / drafted_total if drafted_total else 0.0)

    def _decode(self, active: list[Request]) -> None:
        """One decode step for every decoding slot."""
        seq_lens = np.zeros((self.ecfg.max_batch,), np.int32)
        table_view = np.zeros_like(self.table)
        for r in active:
            seq_lens[r.slot] = r.seq_len
            table_view[r.slot] = self.table[r.slot]
        state = self._state_with_tables(table_view, seq_lens)
        t0 = time.time()
        logits, self.state = self._dispatch_decode(state, seq_lens)
        if self.fault_plan:
            live = {r.slot for r in active}
            for ev in self.fault_plan.nan_slots(self.step_idx):
                if ev.slot in live:
                    self.fault_plan._log(self.step_idx, "nan_logits", ev.slot)
                    logits = logits.clone()
                    logits[ev.slot, 0] = float("nan")
        self._c_blocks_visited.inc(int(sum(-(-r.seq_len // self.page) for r in active)))
        self._c_blocks_full.inc(len(active) * self.span_pages)
        self._note_cost(sum(r.seq_len for r in active),
                        len(active) * self.span_pages * self.page)
        slots = torch.as_tensor([r.slot for r in active], device=logits.device)
        toks, finite = self._postprocess(logits[slots], active)
        self._w_decode_s.inc(time.time() - t0)
        self._c_decode_tokens.inc(len(active))
        self._c_work.inc(len(active))
        for r, tok, ok in zip(active, toks, finite):
            if not ok:
                self._quarantine(r)
                continue
            self._emit(r, int(tok))

    def step(self) -> None:
        """One engine iteration: sweep deadlines, admit, run (budgeted)
        prefill work, grow, one decode (or verify) step for every decoding
        slot, retire finished requests. Virtual time advances even when
        idle."""
        self._sweep_deadlines()
        decode_in_flight = any(r.status is Status.DECODE for r in self.scheduler.active)
        admitted = self._admit()
        t_pre = time.time()
        spent = self._prefill_chunked() if self.chunk > 0 \
            else self._prefill_monolithic(admitted)
        self._c_prefill_tokens.inc(spent)
        self._c_work.inc(spent)
        self.prefill_tokens_series.append(spent)
        self.stall_tokens_series.append(spent if decode_in_flight else 0)
        if decode_in_flight:
            self._w_stall_s.inc(time.time() - t_pre)
        self._ensure_capacity()
        active = [r for r in self.scheduler.active if r.status is Status.DECODE]
        if active and self.proposer is not None:
            self._spec_decode(active)
        elif active:
            self._decode(active)
        live = sum(r.seq_len if r.status is Status.DECODE else r.prefill_pos
                   for r in self.scheduler.active)
        self.util_series.append(self.allocator.stats(live).utilization)
        self._c_steps.inc()
        self.step_idx += 1

    def run(self, requests: list[Request]) -> list[RequestResult]:
        """Run a workload to drain. Requests carry virtual arrival times (in
        engine steps) and are submitted once the engine clock reaches them."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        while i < len(pending) or not self.scheduler.drained:
            while i < len(pending) and pending[i].arrival <= self.step_idx:
                req = pending[i]
                i += 1
                if req.rid in self._seen_rids:
                    continue
                self.submit(req)
            self.step()
        out = []
        for r in sorted(self.scheduler.finished, key=lambda r: r.rid):
            w = self._wall[r.rid]
            out.append(RequestResult(
                rid=r.rid, status=r.status.value, tokens=[int(t) for t in r.out_tokens],
                prompt_len=r.prompt_len,
                ttft_steps=(r.first_token_step - int(r.arrival)
                            if r.first_token_step >= 0 else -1),
                latency_steps=r.finish_step - int(r.arrival),
                ttft_work=(r.first_token_work - r.arrival_work
                           if r.first_token_work >= 0 else -1),
                requeues=r.requeues,
                ttft_s=w.get("first", w["finish"]) - w["arrival"],
                latency_s=w["finish"] - w["arrival"],
                fail_reason=r.fail_reason))
        return out

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def metrics(self) -> dict[str, Any]:
        stats = self.allocator.stats()
        tps = self.decode_tokens / self.decode_seconds if self.decode_seconds else 0.0
        roof_bytes = self._c_roof_bytes.value
        visited, full = self._c_blocks_visited.value, self._c_blocks_full.value
        bounded, fetch_full = self._c_fetch_bounded.value, self._c_fetch_full.value
        slot_steps = self._c_spec_slot_steps.value
        return {
            "steps": self.step_idx,
            "decode_tokens": self.decode_tokens,
            "evictions": self.evictions,
            "requeues": self.scheduler.requeues,
            "wall": {
                "decode_tok_per_s": tps,
                "decode_seconds": self.decode_seconds,
                "prefill_seconds": self.prefill_seconds,
                "stall_seconds": self.stall_seconds,
            },
            "prefill": {
                "mode": "chunked" if self.chunk else "monolithic",
                "chunk": self.chunk,
                "budget": self.ecfg.prefill_budget,
                "traces": self.prefill_traces,
                "tokens": self.prefill_tokens,
                "tokens_series": self.prefill_tokens_series,
            },
            "work": {
                "total": self.work_done,
                "stall_tokens_total": int(sum(self.stall_tokens_series)),
                "stall_tokens_series": self.stall_tokens_series,
            },
            "roofline": {
                "backend": self._backend.name,
                "model_bytes": roof_bytes,
                "bytes_min": self._c_roof_bytes_min.value,
                "flops": self._c_roof_flops.value,
                "achieved_fraction_total": (self._c_roof_bytes_min.value / roof_bytes
                                            if roof_bytes else 0.0),
                "achieved_fraction_last": self._g_roof_frac.value,
            },
            "fetch_work": {
                "pages_fetched_bounded": bounded,
                "pages_fetched_full": fetch_full,
                "fetch_savings": 1.0 - bounded / fetch_full if fetch_full else 0.0,
                "decode_blocks_visited": visited,
                "decode_blocks_full": full,
                "early_exit_savings": 1.0 - visited / full if full else 0.0,
            },
            "pages": {
                "capacity": stats.capacity,
                "free": stats.free,
                "in_use": stats.in_use,
                "cached": stats.cached,
                "peak_in_use": stats.peak_in_use,
                "total_allocs": stats.total_allocs,
                "saved_by_sharing": stats.pages_saved_by_sharing,
            },
            "prefix_cache": {
                "budget_pages": self.ecfg.prefix_cache_pages,
                "host_tier_pages": 0,
                "cached": stats.cached,
                "resident": stats.resident,
                "peak_resident": stats.peak_resident,
                "reused_cached": stats.pages_reused_cached,
                "drops": stats.cache_drops,
                "prefill_skipped_tokens": self.prefill_skipped_tokens,
                "nodes": len(self.allocator.tree) if self.allocator.tree is not None else 0,
            },
            "speculative": {
                "enabled": self.proposer is not None,
                "draft_len": self.ecfg.spec_draft_len,
                "verify_steps": self._c_spec_steps.value,
                "drafted_tokens": self.spec_drafted_tokens,
                "accepted_tokens": self.spec_accepted_tokens,
                "accept_rate": (self.spec_accepted_tokens / self.spec_drafted_tokens
                                if self.spec_drafted_tokens else 0.0),
                "accepted_tokens_per_step": (self.decode_tokens / slot_steps
                                             if slot_steps else 0.0),
            },
            "utilization_series": self.util_series,
            "faults": {**self.faults,
                       "injected": list(self.fault_plan.fired) if self.fault_plan else []},
        }
