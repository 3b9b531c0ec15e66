"""The port's dry run (``launch/dryrun.py``, ``launch/dryrun_sweep.py``, the
specs of ``launch/steps.py``, ``ModelConfig.subquadratic`` / ``has_decoder``
/ ``scaled``) against the reference's.

In process: the shape grid on all 48 (arch x shape) pairs, the config
flags on all 12 ids, and every applicable cell's inputs (``meta`` tensors)
against the reference's ``ShapeDtypeStruct`` specs leaf for leaf (the
reference stacks each pattern slot's layers, and whisper's encoder, on a
leading axis; the port lists them, so a stacked leaf of n layers stands for
n of the port's). In subprocesses: mla-7b x {decode_32k, train_4k} x pod
at 2 layers beside the reference's own ``run_cell`` (``XLA_FLAGS`` set
first), the decode cell's ``_smap`` variant, and one sweep over two cells
the reference skips."""
import collections
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.launch import steps as JS
from repro_torch.checkpoint.checkpoint import dtype_name, flatten
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun_sweep
from repro_torch.launch import steps as TS

ROOT = Path(__file__).resolve().parents[1]
SHAPES = list(JS.SHAPES)
PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES]
CELL_EXTRA = {"n_layers": 2}
FLOPS_RTOL = 0.02


def test_shape_grid_and_config_flags_match_reference():
    assert TS.SHAPES == JS.SHAPES
    for arch, shape in PAIRS:
        assert TS.shape_applicable(get_config(arch), shape) == \
            JS.shape_applicable(j_config(arch), shape), (arch, shape)
    for arch in ARCH_IDS:
        tc, jc = get_config(arch), j_config(arch)
        assert (tc.subquadratic, tc.has_decoder) == (jc.subquadratic, jc.has_decoder), arch
        ts, js = tc.scaled(n_layers=3, kv_fmt="int8"), jc.scaled(n_layers=3, kv_fmt="int8")
        assert (ts.n_layers, ts.kv_fmt, ts.d_model, ts.layer_pattern) == \
            (js.n_layers, js.kv_fmt, js.d_model, js.layer_pattern)
        assert tc.n_layers == jc.n_layers       # scaled() copies


def _ref_counts(tree) -> collections.Counter:
    """(shape, dtype) -> leaves, a stacked leaf counted once per layer."""
    out = collections.Counter()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = {getattr(k, "key", None) for k in path}
        shape, dt = tuple(leaf.shape), str(np.dtype(leaf.dtype))
        if keys & {"scanned", "encoder"}:
            out[(shape[1:], dt)] += shape[0]
        else:
            out[(shape, dt)] += 1
    return out


def _port_counts(tree) -> collections.Counter:
    return collections.Counter((tuple(t.shape), dtype_name(t.dtype)) for _, t in flatten(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every applicable cell: the same kind, and each argument's leaves with
    the reference's shapes and dtypes (bfloat16 weights, int32 tokens,
    float32 aux, the AdamW moments in float32), all on ``meta``."""
    for shape in SHAPES:
        cfg, jcfg = get_config(arch), j_config(arch)
        if not TS.shape_applicable(cfg, shape)[0]:
            with pytest.raises(ValueError, match=arch):
                TS.input_specs(cfg, shape)
            continue
        kind, args = TS.input_specs(cfg, shape)
        jkind, jargs = JS.input_specs(jcfg, shape)
        assert kind == jkind and len(args) == len(jargs), (arch, shape)
        assert all(t.device.type == "meta" for _, t in flatten(args))
        for i, (a, j) in enumerate(zip(args, jargs)):
            assert _port_counts(a) == _ref_counts(j), (arch, shape, i)
        if kind == "train":
            opt, jopt = args[1], jargs[1]
            assert _port_counts(opt.mu) == _ref_counts(jopt.mu) == \
                _port_counts(opt.nu), (arch, shape)
            assert {dtype_name(t.dtype) for _, t in flatten(opt.mu)} == {"float32"}
            assert tuple(opt.step.shape) == () and opt.step.dtype == torch.int32


def _run(code: str, env: dict) -> dict:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=600, env={**os.environ, "PYTHONPATH": "src", **env})
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _port_cell(shape: str, variant: str = "baseline") -> dict:
    return _run("import json; from repro_torch.launch import dryrun as D; D.fake_world(256); "
                f"print(json.dumps(D.run_cell('mla-7b', {shape!r}, 'pod', extra={CELL_EXTRA!r},"
                f" variant={variant!r}), default=str))", {})


def _ref_cell(shape: str) -> dict:
    return _run("import json; from repro.launch import dryrun as D; "
                f"print(json.dumps(D.run_cell('mla-7b', {shape!r}, 'pod', "
                f"extra={CELL_EXTRA!r}), default=str))",
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
                 "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def cells():
    """The five subprocess cells, run in parallel."""
    jobs = {("port", "decode_32k"): lambda: _port_cell("decode_32k"),
            ("port", "train_4k"): lambda: _port_cell("train_4k"),
            ("port", "smap"): lambda: _port_cell("decode_32k", "baseline_smap"),
            ("ref", "decode_32k"): lambda: _ref_cell("decode_32k"),
            ("ref", "train_4k"): lambda: _ref_cell("train_4k")}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_cell_matches_reference_run_cell(cells, shape, record_property):
    """mla-7b x ``shape`` x pod at 2 layers: status ok on 256 chips, the
    per-rank argument bytes equal to the reference's to the byte, and the
    global FLOPs within 2% of the reference's cost-exact count."""
    got, want = cells[("port", shape)], cells[("ref", shape)]
    assert got["status"] == want["status"] == "ok"
    assert got["n_chips"] == want["n_chips"] == 256
    assert got["kind"] == want["kind"] and got["kv_fmt"] == want["kv_fmt"]
    assert got["param_count"] == want["param_count"]
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    ratio = got["flops_global"] / want["flops_global"]
    record_property("flops_ratio", ratio)
    assert abs(ratio - 1) <= FLOPS_RTOL, ratio
    assert got["flops"] == got["flops_global"] / 256
    assert got["memory"]["peak_bytes"] >= got["memory"]["argument_bytes"] > 0
    assert got["collectives"]["total_bytes"] == sum(got["collectives"]["bytes"].values()) > 0
    assert got["collectives"]["counts"]["collective-permute"] == 0


def test_smap_decode_issues_no_collective_in_region(cells):
    """The ``_smap`` decode variant runs every MLA layer's attention through
    the collective-free region: regions entered, no collective inside them,
    and no cache append replicated (the region appends too)."""
    got = cells[("port", "smap")]
    assert got["status"] == "ok" and got["variant"] == "baseline_smap"
    assert got["collectives"]["regions"] >= 2 * CELL_EXTRA["n_layers"]
    assert got["collectives"]["in_region"] == 0
    assert "mla_append" not in got["replicated_ops"]
    assert "mla_append" in cells[("port", "decode_32k")]["replicated_ops"]


def test_sweep_runs_cells_in_subprocesses_and_aggregates(tmp_path, monkeypatch):
    """``dryrun_sweep.main`` over whisper-base and mla-7b x long_500k x pod
    (both skipped, as in the reference): each cell's JSON from its
    subprocess, then ``sweep.json``; a second run reads the cache."""
    monkeypatch.chdir(ROOT)
    argv = ["--out-dir", str(tmp_path), "--jobs", "2", "--mesh", "pod", "--archs",
            "whisper-base", "mla-7b", "--shapes", "long_500k"]
    assert dryrun_sweep.main(argv) == 0
    agg = json.loads((tmp_path / "sweep.json").read_text())
    assert sorted(r["arch"] for r in agg) == ["mla-7b", "whisper-base"]
    for r in agg:
        assert r["status"] == "skipped" and r["mesh"] == "pod"
        assert r["reason"] == JS.shape_applicable(j_config(r["arch"]), "long_500k")[1]
    assert dryrun_sweep.run_one("mla-7b", "long_500k", "pod", tmp_path, 60) == \
        ("mla-7b", "long_500k", "pod", "skipped", "cached")
