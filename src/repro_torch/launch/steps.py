"""Train / prefill / decode / chunked-prefill / verify steps, sampling, the
fused decode loop and the dry run's input specs (port of
``repro/launch/steps.py``).

``input_specs`` builds every (architecture x input shape) cell's arguments
as ``meta`` tensors: the reference's ``ShapeDtypeStruct`` stand-ins, with
shapes and dtypes and no storage, which the step functions run on whole.

``make_fused_decode`` is the reference's one-dispatch decode (a ``lax.scan``
over the steps with the caches donated): here ``DecodeGraph`` runs one decode
step in place over static buffers, and on the card the loop runs that step
once, captures it as a CUDA graph and replays the graph for every later
token, with no host sync in between."""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _lib
from repro_torch.models import transformer as T
from repro_torch.obs.trace import span
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, init_adamw, tree_leaves,
                                    tree_unflatten)
from repro_torch.optim.schedule import warmup_cosine

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether ``cfg`` runs the cell ``shape`` (steps.py:30-36), and why not."""
    seq, gb, kind = SHAPES[shape]
    if kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch; long_500k needs sub-quadratic "
                       "attention (DESIGN.md §5)")
    return True, ""


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    warmup_steps: int = 100, total_steps: int = 10000, remat: bool = True):
    """train_step(params, opt_state, batch, step) -> (new params, new AdamW
    state, metrics) (steps.py:43-58): ``loss_fn``'s value and gradient with
    respect to every parameter (autograd on detached copies; a parameter no
    path reads gets a zero gradient, as ``jax.grad`` gives), then
    ``adamw_update`` at the warmup-cosine lr of ``step``. ``batch`` holds
    ``tokens``, ``labels`` and, for the encoder families, ``aux_embed``.
    Metrics: ``loss``, ``ce``, ``moe_dropped``, ``grad_norm``, ``lr``."""
    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss, metrics = T.loss_fn(tree_unflatten(params, iter(live)), cfg,
                                      batch["tokens"], batch["labels"],
                                      batch.get("aux_embed"), remat=remat)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        lr_scale = warmup_cosine(step, warmup_steps=warmup_steps, total_steps=total_steps)
        new_params, new_opt, om = adamw_update(opt_cfg, tree_unflatten(params, iter(grads)),
                                               opt_state, params, lr_scale)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return new_params, new_opt, {**metrics, **om, "loss": loss.detach()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, state, aux_embed=None):
        return T.prefill(params, cfg, tokens, state, aux_embed)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, state, pos):
        return T.decode_step(params, cfg, token, state, pos)

    return decode_step


def make_ref_decode_step(cfg: ModelConfig):
    """Decode step pinned to the plain reference backend: the serving
    engine's degradation twin (quarantine retry, fallback of a raising
    dispatch)."""
    ref_cfg = dataclasses.replace(cfg, decode_backend="ref", use_kernels=False)

    def ref_decode_step(params, token, state, pos):
        return T.decode_step(params, ref_cfg, token, state, pos)

    return ref_decode_step


def make_verify_step(cfg: ModelConfig, ref: bool = False):
    """verify_step(params, tokens [B, K], state, start [B]) -> (logits
    [B, K, V], state); ``ref=True`` pins the plain reference backend."""
    vcfg = dataclasses.replace(cfg, decode_backend="ref", use_kernels=False) if ref else cfg

    def verify_step(params, tokens, state, start):
        return T.verify_step(params, vcfg, tokens, state, start)

    return verify_step


def make_chunked_prefill_step(cfg: ModelConfig):
    """chunk_prefill_step(params, tokens [B, C], state, chunk_start [B],
    last_idx [B]) -> (logits [B, V] at the last real token, state)."""
    def chunk_prefill_step(params, tokens, state, chunk_start, last_idx):
        return T.chunked_prefill(params, cfg, tokens, state, chunk_start, last_idx)

    return chunk_prefill_step


def chunk_buckets(prefill_chunk: int) -> list[int]:
    """Chunk widths: powers of two below ``prefill_chunk``, then
    ``prefill_chunk`` itself. The engine pads every chunk up to its bucket,
    so it dispatches at most ``len(buckets)`` distinct chunk widths."""
    if prefill_chunk < 1:
        raise ValueError("prefill_chunk must be >= 1 to bucket")
    buckets = []
    b = 1
    while b < prefill_chunk:
        buckets.append(b)
        b *= 2
    buckets.append(prefill_chunk)
    return buckets


def bucket_for(n_tokens: int, prefill_chunk: int) -> int:
    """Smallest bucket covering ``n_tokens`` (the padded chunk width)."""
    for b in chunk_buckets(prefill_chunk):
        if b >= n_tokens:
            return b
    raise ValueError(f"{n_tokens} tokens exceed prefill_chunk {prefill_chunk}")


def masked_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The temperature-scaled logits ``sample_logits`` draws from: top-k, then
    nucleus (top-p) truncation, dropped entries set to -inf."""
    scaled = logits.float() / temperature
    if 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if 0.0 < top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep while the mass BEFORE a token is < top_p: the first token is
        # always kept, and the token that crosses the threshold is included
        keep = (cum - probs) < top_p
        cutoff = torch.amin(torch.where(keep, desc, float("inf")), dim=-1,
                            keepdim=True)
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    return scaled


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Next-token selection from [B, V] logits: ``temperature <= 0`` is greedy
    argmax (generator unused), otherwise a categorical draw from
    ``masked_logits`` with ``generator``: the argmax of ``p / Exp(1)``, which
    is how ``torch.multinomial`` draws one sample (the same draws from the
    same generator), without its host-side check of ``p``, so it can run
    inside a CUDA graph."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(masked_logits(logits, temperature, top_k, top_p), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def apply_eos(tok: torch.Tensor, done: torch.Tensor, eos_id: int | None):
    """Pin sequences that already finished to ``eos_id``, then fold this
    step's emissions into the done mask. No-op when ``eos_id`` is None."""
    if eos_id is None:
        return tok, done
    tok = torch.where(done, torch.full_like(tok, eos_id), tok)
    return tok, done | (tok == eos_id)


def _copy_back(static, new, where: str = "state") -> None:
    """Write a step's returned state ``new`` into the ``static`` one it was
    given, leaf by leaf: a tensor leaf the step replaced (``seq_lens``, which
    every append returns anew) is copied into the static tensor; one written
    in place is left alone. A leaf whose shape, dtype or kind changed
    raises."""
    if isinstance(static, torch.Tensor):
        if not isinstance(new, torch.Tensor) or new.shape != static.shape \
                or new.dtype != static.dtype:
            raise ValueError(f"{where}: a decode step changed {tuple(static.shape)} "
                             f"{static.dtype} into {new!r:.80}")
        if new.data_ptr() != static.data_ptr():
            static.copy_(new)
    elif isinstance(static, dict):
        if static.keys() != new.keys():
            raise ValueError(f"{where}: keys {sorted(static)} became {sorted(new)}")
        for k in static:
            _copy_back(static[k], new[k], f"{where}[{k!r}]")
    elif isinstance(static, (list, tuple)):
        if type(new) is not type(static) or len(new) != len(static):
            raise ValueError(f"{where}: {type(static).__name__} of {len(static)} became "
                             f"{type(new).__name__}")
        names = getattr(static, "_fields", range(len(static)))
        for name, a, b in zip(names, static, new):
            _copy_back(a, b, f"{where}.{name}" if isinstance(name, str) else f"{where}[{name}]")
    elif static is not new:
        raise ValueError(f"{where}: {static!r} became {new!r:.80}")


class DecodeGraph:
    """One decode step of ``cfg`` over static buffers — the token ``tok``
    [B] int32, the position ``pos`` [B], the finished mask ``done`` [B], the
    all-finite flag ``ok`` and the decode ``state`` (prefill's, updated in
    place) — with ``make_fused_decode``'s sampling and EOS rules.

    ``step()`` runs it eagerly and returns its logits [B, V]; on the card,
    after one ``step()`` has grown every buffer the step allocates outside
    PyTorch's pool (the decode kernels' scratch), ``capture(stream)`` records
    it into a CUDA graph (its kernel launches in ``graph_launches``) and
    ``replay()`` runs the graph: the next step, one launch."""

    def __init__(self, cfg: ModelConfig, params, token: torch.Tensor, state,
                 start_pos: torch.Tensor, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int | None = None,
                 gate_finished: bool = True, generator: torch.Generator | None = None):
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature > 0 needs a torch.Generator")
        self.cfg, self.params, self.state = cfg, params, state
        self.sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        self.generator = generator if temperature > 0.0 else None
        self.eos_id = eos_id
        self.gated = gate_finished and eos_id is not None
        dev = token.device
        self.tok = token.to(torch.int32).clone()
        self.pos = start_pos.to(device=dev, dtype=torch.int32).clone()
        # a row whose incoming token is already EOS is born finished
        self.done = (self.tok == eos_id) if eos_id is not None \
            else torch.zeros(self.tok.shape, dtype=torch.bool, device=dev)
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.graph_launches: dict = {}
        self._logits: torch.Tensor | None = None

    def step(self) -> torch.Tensor:
        logits, new = T.decode_step(self.params, self.cfg, self.tok, self.state, self.pos,
                                    active=~self.done if self.gated else None)
        self.ok.logical_and_(torch.all(torch.isfinite(logits)))
        nxt, done = apply_eos(sample_logits(logits, self.generator, **self.sample),
                              self.done, self.eos_id)
        self.tok.copy_(nxt)
        if done is not self.done:
            self.done.copy_(done)
        self.pos.add_(1)
        _copy_back(self.state, new)
        return logits

    def capture(self, stream: torch.cuda.Stream | None = None) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = collections.Counter(_lib.CAPTURED)
        with torch.cuda.graph(graph, stream=stream):
            self._logits = self.step()
        self.graph_launches = dict(_lib.CAPTURED - before)
        self.graph = graph

    def replay(self) -> torch.Tensor:
        """The next step through the captured graph; its logits [B, V] (the
        graph's own buffer, rewritten by the next replay)."""
        self.graph.replay()
        return self._logits

    def release(self) -> None:
        """Drop the captured graph and its private pool: the graph's logits
        buffer is let go and the pool is handed back to the caching
        allocator, which frees its memory to the device when it next runs
        short. The static buffers and the state stay; ``replay`` needs a new
        ``capture``."""
        self._logits = None
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def make_fused_decode(cfg: ModelConfig, n_steps: int, *, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 0.0, eos_id: int | None = None,
                      gate_finished: bool = True, return_logits: bool = False):
    """Multi-token decode with a static trip count (steps.py:188-262).

    Returns fused(params, token [B], state, start_pos [B], generator=None,
    stats=None) -> (tokens [B, n_steps] int32, state, ok) — plus every step's
    logits [B, n_steps, V] when ``return_logits``. ``state`` is updated in
    place (the reference donates it) and returned; ``ok`` is a 0-d bool
    tensor, the AND of an all-finite check over every step's logits.

    The loop never stops early and never reads ``done`` on the host. With
    ``eos_id``, finished rows are pinned to ``eos_id``, and with
    ``gate_finished`` they run ``decode_step(..., active=~done)``: their
    ``seq_lens`` freeze. ``temperature > 0`` draws from ``generator`` (one
    is required); ``temperature <= 0`` is greedy.

    On CUDA tensors the first step runs eagerly on a side stream (it is real
    work, and it grows every buffer a capture must not allocate), that step
    is captured once as a CUDA graph, and the graph is replayed for steps
    2..n; after each replay the host only enqueues the copies of the token
    (and the logits) into their output slots, and it synchronizes once at
    the end. The graph and its private pool are released before the call
    returns. A failed capture raises. On CPU tensors, which only a caller
    can ask for, the same step runs eagerly n times.

    Each call records its phases as host ranges in ``torch.profiler``'s
    trace (``obs.trace.span``; nothing is recorded without a profiler):
    ``snapmla.round``, the whole call, and inside it in this order
    ``snapmla.round.buffers`` (the static buffers, the token and logits
    outputs), ``.eager`` (the first step's host launches), ``.capture``
    (``DecodeGraph.capture`` with instantiation; card, n > 1),
    ``.first_sync`` (the wait for the eager step's device work; card),
    ``.replays`` (steps 2..n with their copies and the final synchronize;
    the eager steps on the CPU) and ``.release`` (card).

    ``stats`` (a dict) receives, from the same clock reads as those ranges
    (host seconds): ``capture_s`` (the first step and the capture, to the
    end of ``first_sync``), ``eager_s`` (the first step's launches),
    ``steps_timed`` and ``decode_s`` (the steps after the first and their
    wall, ``replays``), ``release_s`` (``release``), ``replays`` (graph
    replays) and ``graph_launches`` (the kernel launches recorded into the
    graph; they run at every replay)."""
    def fused_decode(params, token, state, start_pos, generator=None, stats=None):
        with span("snapmla.round"):
            return _round(params, token, state, start_pos, generator, stats)

    def _round(params, token, state, start_pos, generator, stats):
        with span("snapmla.round.buffers"):
            loop = DecodeGraph(cfg, params, token, state, start_pos, temperature=temperature,
                               top_k=top_k, top_p=top_p, eos_id=eos_id,
                               gate_finished=gate_finished, generator=generator)
            dev = loop.tok.device
            if dev.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {dev}")
            B = loop.tok.shape[0]
            toks = torch.empty((B, n_steps), dtype=torch.int32, device=dev)
            all_logits = torch.empty((B, n_steps, cfg.vocab_size), dtype=torch.float32,
                                     device=dev) if return_logits else None

        def keep(i, logits):
            toks[:, i].copy_(loop.tok)
            if all_logits is not None:
                all_logits[:, i].copy_(logits)

        on_card = dev.type == "cuda"
        eager, first_sync = span("snapmla.round.eager"), span("snapmla.round.first_sync")
        replays, release = span("snapmla.round.replays"), span("snapmla.round.release")
        if n_steps:
            with eager:
                if on_card:
                    side = torch.cuda.Stream(device=dev)
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side):
                        keep(0, loop.step())
                else:
                    keep(0, loop.step())
            if on_card:
                if n_steps > 1:
                    with span("snapmla.round.capture"):
                        loop.capture(side)
                with first_sync:
                    torch.cuda.current_stream(dev).wait_stream(side)
                    torch.cuda.synchronize(dev)
            with replays:
                for i in range(1, n_steps):
                    keep(i, loop.replay() if on_card else loop.step())
                if on_card:
                    torch.cuda.synchronize(dev)
        if on_card:
            with release:
                loop.release()
        if stats is not None:
            stats.update(capture_s=(first_sync.t1 if on_card else eager.t1) - eager.t0,
                         eager_s=eager.s, steps_timed=max(n_steps - 1, 0), decode_s=replays.s,
                         release_s=release.s,
                         replays=max(n_steps - 1, 0) if on_card else 0,
                         graph_launches=loop.graph_launches)
        out = (toks, loop.state, loop.ok)
        return out + (all_logits,) if return_logits else out

    return fused_decode


# ---------------------------------------------------------------------------
# The dry run's input specs: meta tensors (no allocation)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def params_spec(cfg: ModelConfig, dtype=torch.bfloat16):
    """``init_model``'s tree on ``meta``: every leaf's shape and dtype."""
    return T.init_model(torch.Generator(), cfg, dtype=dtype, device=META)


def state_spec(cfg: ModelConfig, batch: int, max_len: int):
    """The decode state of ``batch`` rows over ``max_len`` tokens, on
    ``meta``; the encoder families' ``aux`` rows (float32) live in it after
    prefill."""
    s = T.init_decode_state(cfg, batch, max_len, device=META)
    if cfg.n_aux_tokens:
        s["aux"] = torch.empty((batch, cfg.n_aux_tokens, cfg.d_model), dtype=torch.float32,
                               device=META)
    return s


def _ints(*shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


def input_specs(cfg: ModelConfig, shape: str, param_dtype=torch.bfloat16):
    """(step kind, the step's arguments as ``meta`` tensors) of the cell
    ``shape`` (steps.py:281-306): ``train`` (params, AdamW state, batch,
    step), ``prefill`` (params, tokens, state[, aux]) or ``decode`` (params,
    token, state, pos). Tokens are int32, aux rows float32."""
    seq, gb, kind = SHAPES[shape]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    params = params_spec(cfg, param_dtype)
    aux = torch.empty((gb, cfg.n_aux_tokens, cfg.d_model), dtype=torch.float32,
                      device=META) if cfg.n_aux_tokens else None
    if kind == "train":
        batch = {"tokens": _ints(gb, seq), "labels": _ints(gb, seq)}
        if aux is not None:
            batch["aux_embed"] = aux
        return "train", (params, init_adamw(params), batch, _ints())
    if kind == "prefill":
        args = (params, _ints(gb, seq), T.init_decode_state(cfg, gb, seq, device=META))
        return "prefill", args + ((aux,) if aux is not None else ())
    # decode: one new token against a cache of ``seq``
    return "decode", (params, _ints(gb), state_spec(cfg, gb, seq), _ints(gb))


def step_fn_for(cfg: ModelConfig, kind: str, remat: bool = True):
    if kind == "train":
        return make_train_step(cfg, remat=remat)
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)
