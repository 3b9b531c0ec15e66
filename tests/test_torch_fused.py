"""The port's fused decode loop (``steps.make_fused_decode``,
``serve.generate_fused``, ``serve --fused``) on the CPU, where it runs the
same in-place step eagerly, against the JAX package on the smoke configs
with the same (bridged) weights and prompts:

  * greedy ``generate_fused`` token-exact against JAX's ``generate_fused``
    and against the port's ``generate`` (logits bitwise), on mla-7b
    contiguous and paged x kv_splits {1, 2} x {FMA, AMLA} (JAX: its
    reference backend for FMA, its Pallas kernels in interpret mode for
    AMLA), llama3.2-3b and deepseek-v3-mla (q-LoRA + MoE);
  * EOS pins every later slot; finished-row gating gives the same tokens
    on or off, and a finished row's ``seq_lens`` equals the JAX
    ``make_fused_decode`` state's; the gate without ``eos_id`` changes no
    bit (tests/test_backends.py:298, :321, :361);
  * a NaN weight clears ``ok`` and makes ``generate_fused`` exit;
  * sampling is reproducible per seed, inside the top-k support and equal
    to ``generate``'s draws with the same seed;
  * ``gen_steps`` 1 and 2, the state write-back's checks, and the
    ``serve --fused`` command line."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import kvcache as tkv
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S, GEN = 3, 12, 8
ARCHS = ("mla-7b", "llama3.2-3b", "deepseek-v3-mla")


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX smoke params, the port's bridged copy and prompts."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
        out[arch] = (jcfg, jparams, tparams)
    return out


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)


def t_cfg(arch, **over):
    return dataclasses.replace(t_smoke(arch), decode_backend="kernel", use_kernels=True,
                               **over)


def check_fused(models, prompts, arch, jax_backend="ref", **over):
    """Greedy generate_fused: JAX's tokens, and the port's generate's tokens
    and logits bit for bit, with no kernel launch (CPU tensors)."""
    jcfg, jparams, tparams = models[arch]
    jcfg = dataclasses.replace(jcfg, decode_backend=jax_backend,
                               use_kernels=jax_backend == "kernel", **over)
    j_toks, _ = jserve.generate_fused(jcfg, jparams, jnp.asarray(prompts), GEN)
    cfg = t_cfg(arch, **over)
    p = torch.from_numpy(prompts)
    _lib.reset_launches()
    stats: dict = {}
    f_toks, tps, f_logits = tserve.generate_fused(cfg, tparams, p, GEN, return_logits=True,
                                                  stats=stats)
    assert sum(_lib.LAUNCHES.values()) == sum(_lib.CAPTURED.values()) == 0
    assert stats["replays"] == 0 and stats["steps_timed"] == GEN - 2 and tps > 0
    toks, _, logits = tserve.generate(cfg, tparams, p, GEN, return_logits=True)
    assert f_toks.shape == (B, GEN) and f_toks.dtype == torch.int32
    np.testing.assert_array_equal(f_toks.numpy(), np.asarray(j_toks))
    assert torch.equal(f_toks, toks)
    assert torch.equal(f_logits, logits)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("kv_splits", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mla_generate_fused_matches_jax_and_generate(models, prompts, paged, kv_splits,
                                                     rescale):
    check_fused(models, prompts, "mla-7b", "kernel" if rescale == "amla" else "ref",
                kv_paged=paged, kv_splits=kv_splits, kv_rescale=rescale)


def test_llama_generate_fused_matches_jax_and_generate(models, prompts):
    check_fused(models, prompts, "llama3.2-3b")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_deepseek_generate_fused_matches_jax_and_generate(models, prompts, paged):
    check_fused(models, prompts, "deepseek-v3-mla", kv_paged=paged)


@pytest.mark.parametrize("fused", [False, True], ids=["step-loop", "fused"])
def test_eos_pins_every_token_after_first_hit(models, prompts, fused):
    """tests/test_backends.py:298 on the port: every slot after a row's
    first EOS is EOS, the shape stays [B, gen_steps]."""
    tparams = models["mla-7b"][2]
    cfg = t_cfg("mla-7b")
    gen_fn = tserve.generate_fused if fused else tserve.generate
    p = torch.from_numpy(prompts)
    free, _ = gen_fn(cfg, tparams, p, 6)
    eos = int(free[0, 2])
    toks, _ = gen_fn(cfg, tparams, p, 6, eos_id=eos)
    toks = toks.numpy()
    assert toks.shape == (B, 6)
    for row in toks:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    assert (toks[0, 2:] == eos).all()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_gate_finished_token_identical_and_freezes_lens_as_jax(models, paged):
    """tests/test_backends.py:321 on the port, and the frozen ``seq_lens``
    equal to the JAX fused scan's final state, row for row."""
    jcfg, jparams, tparams = models["mla-7b"]
    jcfg = dataclasses.replace(jcfg, kv_paged=paged, decode_backend="ref")
    cfg = t_cfg("mla-7b", kv_paged=paged)
    n, gen = 16, 8
    pr = np.random.RandomState(4).randint(0, 256, (B, n)).astype(np.int32)
    free, _ = tserve.generate(cfg, tparams, torch.from_numpy(pr), gen)
    eos = int(free[0, 2])                    # row 0 finishes at step 2
    max_len = tserve._decode_capacity(cfg, n, gen)
    runs = {}
    for gate in (True, False):
        state = TT.init_decode_state(cfg, B, max_len, device="cpu")
        logits, state = TT.prefill(tparams, cfg, torch.from_numpy(pr), state)
        tok = logits.argmax(-1).to(torch.int32)
        fused = tsteps.make_fused_decode(cfg, gen - 1, eos_id=eos, gate_finished=gate)
        toks, state_out, ok = fused(tparams, tok, state,
                                    torch.full((B,), n, dtype=torch.int32))
        assert bool(ok) and state_out is state
        runs[gate] = (toks.numpy(), state_out["layers"][0].seq_lens.numpy())
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    gated, ungated = runs[True][1], runs[False][1]
    assert (ungated == n + gen - 1).all()
    out0 = np.concatenate([[int(free[0, 0])], runs[True][0][0]])
    hit = int(np.flatnonzero(out0 == eos)[0])
    assert gated[0] == n + hit < n + gen - 1
    assert (gated[1:] == n + gen - 1).all()
    # the JAX fused scan's final state, from the same weights and prompts
    jstate = JT.init_decode_state(jcfg, B, max_len)
    jlogits, jstate = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, jnp.asarray(pr), jstate)
    jfused = jax.jit(jsteps.make_fused_decode(jcfg, gen - 1, eos_id=eos), donate_argnums=(2,))
    jtoks, jstate_out, jok = jfused(jparams, jnp.argmax(jlogits, -1).astype(jnp.int32),
                                    jstate, jnp.full((B,), n, jnp.int32))
    assert bool(jok)
    np.testing.assert_array_equal(runs[True][0], np.asarray(jtoks))
    np.testing.assert_array_equal(gated, np.asarray(jstate_out["scanned"][0].seq_lens)[0])


def test_gate_without_eos_is_bit_identical(models, prompts):
    """tests/test_backends.py:361 on the port: ``gate_finished`` without an
    ``eos_id`` changes no bit of the logits, the tokens or the state."""
    tparams = models["mla-7b"][2]
    cfg = t_cfg("mla-7b", kv_paged=True)
    outs = []
    for gate in (True, False):
        state = TT.init_decode_state(cfg, B, tserve._decode_capacity(cfg, S, 5), device="cpu")
        logits, state = TT.prefill(tparams, cfg, torch.from_numpy(prompts), state)
        fused = tsteps.make_fused_decode(cfg, 4, gate_finished=gate, return_logits=True)
        outs.append(fused(tparams, logits.argmax(-1).to(torch.int32), state,
                          torch.full((B,), S, dtype=torch.int32)))
    (ta, sa, oka, la), (tb, sb, okb, lb) = outs
    assert torch.equal(ta, tb) and torch.equal(la, lb) and bool(oka) and bool(okb)
    for a, b in zip(sa["layers"], sb["layers"]):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x,
                               y.view(torch.uint8) if y.dtype == torch.float8_e4m3fn else y)
    g, _ = tserve.generate_fused(cfg, tparams, torch.from_numpy(prompts), 5)
    s, _ = tserve.generate(cfg, tparams, torch.from_numpy(prompts), 5)
    assert torch.equal(g, s)


def test_nan_weight_clears_ok_and_generate_fused_exits(models):
    """A NaN in the embedding row of the token row 0 generates first: the
    prefill (an untied copy of the table unembeds it, and no prompt holds
    that token) stays finite, the first decode step is not; ``ok`` goes
    False and ``generate_fused`` exits at its fused-decode gate."""
    tparams = models["mla-7b"][2]
    cfg = t_cfg("mla-7b")
    pr = torch.from_numpy(np.random.RandomState(12).randint(0, 256, (2, S)).astype(np.int32))
    free, _ = tserve.generate(cfg, tparams, pr, 2)
    first = int(free[0, 0])
    assert first not in pr.tolist()[0] + pr.tolist()[1]
    poisoned = {**tparams, "embed": tparams["embed"].clone(), "unembed": tparams["embed"]}
    poisoned["embed"][first] = float("nan")
    state = TT.init_decode_state(cfg, 2, tserve._decode_capacity(cfg, S, 4), device="cpu")
    logits, state = TT.prefill(poisoned, cfg, pr, state)
    assert torch.isfinite(logits).all()
    toks, _, ok = tsteps.make_fused_decode(cfg, 3)(
        poisoned, logits.argmax(-1).to(torch.int32), state, torch.full((2,), S, dtype=torch.int32))
    assert toks.shape == (2, 3) and not bool(ok)
    with pytest.raises(SystemExit, match="fused decode"):
        tserve.generate_fused(cfg, poisoned, pr, 4)


@pytest.mark.parametrize("arch", ["mla-7b", "deepseek-v3-mla"])
def test_sampling_reproducible_in_support_and_equal_to_generate(models, prompts, arch):
    tparams = models[arch][2]
    cfg = t_cfg(arch, kv_paged=True)
    p = torch.from_numpy(prompts)
    kw = dict(temperature=0.8, top_k=8, top_p=0.9, seed=7)
    a, _, logits = tserve.generate_fused(cfg, tparams, p, 6, return_logits=True, **kw)
    b, _ = tserve.generate_fused(cfg, tparams, p, 6, **kw)
    c, _ = tserve.generate(cfg, tparams, p, 6, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    top = torch.topk(logits, 8, dim=-1).indices
    assert (top == a[..., None].long()).any(-1).all()
    d, _ = tserve.generate_fused(cfg, tparams, p, 6, **{**kw, "seed": 8})
    assert not torch.equal(a, d)
    with pytest.raises(ValueError, match="torch.Generator"):
        tsteps.make_fused_decode(cfg, 2, temperature=0.8)(tparams, a[:, 0], None, a[:, 0])


def test_sample_logits_draws_as_multinomial():
    """The race draw takes ``torch.multinomial``'s one-sample draws from the
    same generator (the port's sampled tokens before the fused loop)."""
    logits = torch.from_numpy(np.random.RandomState(2).standard_normal((6, 50)) * 3).float()
    probs = torch.softmax(tsteps.masked_logits(logits, 0.7, 9, 0.8), dim=-1)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(4):
        got = tsteps.sample_logits(logits, g1, 0.7, 9, 0.8)
        want = torch.multinomial(probs, 1, generator=g2)[:, 0].to(torch.int32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("gen_steps", [1, 2])
def test_generate_fused_few_steps_shapes(models, prompts, gen_steps):
    """tests/test_backends.py:391 on the port, and two steps (one fused
    decode step, nothing to replay)."""
    jcfg, jparams, tparams = models["mla-7b"]
    cfg = t_cfg("mla-7b")
    p = torch.from_numpy(prompts)
    a, tps_a, la = tserve.generate_fused(cfg, tparams, p, gen_steps, return_logits=True)
    b, _, lb = tserve.generate(cfg, tparams, p, gen_steps, return_logits=True)
    assert a.shape == b.shape == (B, gen_steps) and la.shape == lb.shape
    assert torch.equal(a, b) and torch.equal(la, lb) and tps_a == 0.0
    j, _ = jserve.generate_fused(dataclasses.replace(jcfg, decode_backend="ref"), jparams,
                                 jnp.asarray(prompts), gen_steps)
    np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def test_copy_back_copies_replaced_leaves_and_rejects_changes():
    cache = tkv.MLACache(torch.zeros(2, 4, 3), torch.zeros(2, 4, 2), torch.ones(2, 4),
                         torch.zeros(2, dtype=torch.int32))
    state = {"layers": [cache]}
    content = cache.content
    new = {"layers": [cache._replace(seq_lens=cache.seq_lens + 1)]}
    new["layers"][0].content[0, 0, 0] = 5.0            # written in place
    tsteps._copy_back(state, new)
    assert state["layers"][0].content is content and float(content[0, 0, 0]) == 5.0
    assert state["layers"][0].seq_lens.tolist() == [1, 1]
    for bad in (cache._replace(seq_lens=torch.zeros(3, dtype=torch.int32)),
                cache._replace(seq_lens=torch.zeros(2, dtype=torch.int64)),
                cache._replace(sink=torch.zeros(2, 1, 3))):
        with pytest.raises(ValueError):
            tsteps._copy_back(state, {"layers": [bad]})


def _bits(x):
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def test_fused_round_spans_nest_in_order_and_change_no_bit(models, prompts):
    """Under ``torch.profiler`` each ``make_fused_decode`` call records one
    ``snapmla.round`` host range with the CPU path's phases inside it, in
    order, and every output (tokens, ``ok``, logits, the state) is bitwise
    the same as without the profiler; ``stats`` has every key."""
    tparams = models["mla-7b"][2]
    cfg = t_cfg("mla-7b", kv_paged=True)
    n, calls = 4, 2
    fused = tsteps.make_fused_decode(cfg, n, return_logits=True)

    def rounds():
        state = TT.init_decode_state(cfg, B, tserve._decode_capacity(cfg, S, n * calls + 1),
                                     device="cpu")
        logits, state = TT.prefill(tparams, cfg, torch.from_numpy(prompts), state)
        tok, pos = logits.argmax(-1).to(torch.int32), torch.full((B,), S, dtype=torch.int32)
        outs = []
        for _ in range(calls):
            stats: dict = {}
            toks, state, ok, lg = fused(tparams, tok, state, pos, stats=stats)
            outs.append((toks, ok, lg, stats))
            tok, pos = toks[:, -1], pos + n
        return outs, state

    plain, plain_state = rounds()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced, traced_state = rounds()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("snapmla.")), key=lambda x: (x[1], -x[2]))
    tops = [x for x in spans if x[0] == "snapmla.round"]
    assert len(tops) == calls and len(spans) == 4 * calls
    for _, a, b in tops:
        inner = [x for x in spans if x[0] != "snapmla.round" and a <= x[1] and x[2] <= b]
        assert [x[0] for x in inner] == ["snapmla.round.buffers", "snapmla.round.eager",
                                         "snapmla.round.replays"]
        assert all(x[2] <= y[1] for x, y in zip(inner, inner[1:]))
    keys = {"capture_s", "eager_s", "steps_timed", "decode_s", "release_s", "replays",
            "graph_launches"}
    for (ta, oka, la, sa), (tb, okb, lb, sb) in zip(plain, traced):
        assert torch.equal(ta, tb) and torch.equal(la, lb) and bool(oka) and bool(okb)
        assert set(sa) == set(sb) == keys
        assert sb["capture_s"] == sb["eager_s"] > 0 and sb["decode_s"] > 0
        assert sb["release_s"] == 0.0 and sb["replays"] == 0 and sb["steps_timed"] == n - 1
    for a, b in zip(plain_state["layers"], traced_state["layers"]):
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("flags", [[], ["--paged", "--kv-splits", "2", "--rescale", "amla"],
                                   ["--arch", "llama3.2-3b"],
                                   ["--arch", "deepseek-v3-mla", "--temperature", "0.8",
                                    "--top-k", "5"]])
def test_serve_main_fused_cpu(capsys, flags):
    tserve.main(["--smoke", "--fused", "--backend", "kernel", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "10", "--gen", "4", *flags])
    out = capsys.readouterr().out
    assert "fused-graph" in out and "generated (2, 4)" in out
    assert "token agreement vs BF16 pipeline" in out
