"""The port's split autotuner (``kernels/mla_decode/autotune.py``) and its
resolution rule (``ops.resolve_num_splits`` / ``resolve_split_config``) —
tests/test_autotune.py's behaviours with synthetic timers: exact hit ->
nearest batch (log space, ties to the smaller batch) -> heuristic; layouts
and rescales never mixing; the win margin; malformed entries skipped; v1
files migrating to v2; save / load round trips; the joint (num_splits,
block_n) plan. Also: a profile the reference's ``SplitProfile`` saved loads
into the port's with equal plans; the port's default file is its own (never
``BENCH_splits_profile.json``) and records the card; the backends pass the
batch, layout and rescale to the lookup. No test reads the committed
profile: each starts from a throwaway path."""
import json

import numpy as np
import pytest
import torch

from repro.kernels.mla_decode import autotune as jautotune
from repro_torch.kernels.mla_decode import autotune
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import ops
from repro_torch.kernels.mla_decode.ops import (default_num_splits, resolve_num_splits,
                                                resolve_split_config)

SC = autotune.SplitConfig


@pytest.fixture(autouse=True)
def _isolated_profile(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.PROFILE_ENV, str(tmp_path / "splits_profile.json"))
    autotune.reset()
    yield
    autotune.reset()


def test_default_file_is_the_ports_own():
    assert autotune.DEFAULT_PROFILE.name == "H100_splits_profile.json"
    assert (autotune.DEFAULT_PROFILE.parent / "src" / "repro_torch").is_dir()
    assert autotune.PROFILE_ENV != jautotune.PROFILE_ENV
    assert autotune.DEFAULT_PROFILE != jautotune.DEFAULT_PROFILE


def test_resolve_edge_cases_and_heuristic_fallback():
    assert resolve_num_splits(None, 64, 128) == 1
    assert resolve_num_splits(8, 64, 128) == 1
    assert resolve_num_splits(8, 256, 128) == 2
    assert resolve_num_splits(1000, 1024, 128) == 8
    assert resolve_num_splits(3, 1024, 128) == 3
    for cap in (256, 4096, 8192, 32768, 131072):
        expect = default_num_splits(cap, 128)
        assert resolve_num_splits(None, cap, 128, batch=4) == expect
        assert resolve_num_splits(0, cap, 128, batch=4) == expect
    assert resolve_num_splits(None, 32768, 128) == default_num_splits(32768, 128)


def test_resolution_order_exact_nearest_heuristic():
    profile = autotune.SplitProfile()
    profile.record(32768, 128, 2, {1: 900.0, 2: 500.0})
    profile.record(32768, 128, 64, {1: 900.0, 8: 400.0})
    autotune.reset(profile)
    assert resolve_num_splits(None, 32768, 128, batch=2) == 2            # exact
    assert resolve_num_splits(None, 32768, 128, batch=4) == 2            # nearest: 2
    assert profile.lookup_nearest(32768, 128, 32) == 8
    assert profile.lookup_nearest(32768, 128, 16) == 8                   # 4x beats 8x
    assert resolve_num_splits(None, 16384, 128, batch=4) == default_num_splits(16384, 128)
    assert resolve_num_splits(2, 32768, 128, batch=64) == 2              # explicit wins
    assert profile.lookup(32768, 128, 4) is None
    assert profile.lookup_nearest(32768, 128, None) is None
    assert profile.lookup_nearest(32768, 64, 4) is None
    assert profile.lookup_nearest(32768, 128, 4, layout="paged") is None
    tie = autotune.SplitProfile()
    tie.record(4096, 128, 2, {1: 100.0, 2: 50.0})
    tie.record(4096, 128, 8, {1: 100.0, 4: 50.0})
    assert tie.lookup_nearest(4096, 128, 4) == 2                         # tie: smaller


def test_malformed_entries_are_skipped():
    profile = autotune.SplitProfile({
        "32768/128/8": {"best": "garbage"}, "not-a-key": {"best": 4},
        "32768/128/oops": {"best": 4}, "32768/128/2": {"best": 2, "measured_us": {}},
        "512/64/2": {"measured_us": {"1": 100.0}}, "1024/64/2": "garbage"})
    autotune.reset(profile)
    assert profile.lookup_nearest(32768, 128, 4) == 2
    assert profile.lookup(512, 64, 2) is None and profile.lookup(1024, 64, 2) is None
    assert resolve_num_splits(None, 512, 64, batch=2) == default_num_splits(512, 64)


@pytest.mark.parametrize("axis", ["layout", "rescale"])
def test_layouts_and_rescales_never_mix(axis):
    other = {"layout": "paged"} if axis == "layout" else {"rescale": "amla"}
    profile = autotune.SplitProfile()
    profile.record(32768, 128, 4, {1: 900.0, 4: 400.0})
    profile.record(32768, 128, 4, {1: 900.0, 2: 300.0, 4: 400.0}, **other)
    autotune.reset(profile)
    assert resolve_num_splits(None, 32768, 128, batch=4) == 4
    assert resolve_num_splits(None, 32768, 128, batch=4, **other) == 2
    assert profile.lookup_nearest(32768, 128, 8, **other) == 2
    assert profile.lookup_config(32768, 4) == SC(4, 128)
    assert profile.lookup_config(32768, 4, **other) == SC(2, 128)
    only = autotune.SplitProfile()
    only.record(32768, 128, 2, {4: 100.0}, **other)
    autotune.reset(only)
    assert resolve_num_splits(None, 32768, 128, batch=2) == default_num_splits(32768, 128)
    only.record(32768, 128, 2, {2: 100.0}, layout="paged", rescale="amla")
    assert "32768/128/2/paged/amla" in only.entries


def test_win_margin_ties_go_to_fewer_splits():
    profile = autotune.SplitProfile()
    assert autotune.WIN_MARGIN == jautotune.WIN_MARGIN
    assert profile.record(4096, 128, 2, {1: 100.0, 2: 97.0, 4: 99.0}) == 1
    assert profile.record(4096, 128, 4, {1: 100.0, 2: 80.0, 4: 79.0}) == 2
    assert profile.record(4096, 128, 8, {1: 100.0, 4: 50.0}) == 4
    profile.record(256, 128, 2, {8: 100.0})                     # 8 > the 2 blocks
    autotune.reset(profile)
    assert resolve_num_splits(None, 256, 128, batch=2) == 2


def test_save_load_round_trips_with_the_device(tmp_path):
    p = tmp_path / "prof.json"
    profile = autotune.SplitProfile(device={"name": "NVIDIA H100 80GB HBM3",
                                            "power_limit": "700.00 W"})
    assert profile.record(4096, 128, 2, {1: 300.0, 2: 200.5, 4: 250.0}) == 2
    profile.record(4096, 128, 2, {1: 900.0, 4: 300.0}, rescale="amla")
    profile.save(p)
    payload = json.loads(p.read_text())
    assert payload["version"] == autotune.PROFILE_VERSION == 2
    assert set(payload["entries"]) == {"4096/128/2", "4096/128/2/amla"}
    assert payload["entries"]["4096/128/2"]["measured_us"]["2"] == 200.5
    loaded = autotune.SplitProfile.load(p)
    assert loaded.device == profile.device and loaded.entries == profile.entries
    assert loaded.lookup(4096, 128, 2) == 2 and loaded.lookup(4096, 128, 3) is None
    assert loaded.lookup(4096, 128, 2, rescale="amla") == 4
    # the default path: the environment variable, lazily read once
    profile.save()
    assert autotune.get_profile().lookup(4096, 128, 2) == 2


def test_load_missing_corrupt_or_other_version_is_empty(tmp_path):
    assert autotune.SplitProfile.load(tmp_path / "nope.json").entries == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert autotune.SplitProfile.load(bad).entries == {}
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"version": 999, "entries": {"a": 1}}))
    assert autotune.SplitProfile.load(wrong).entries == {}


def test_v1_profile_migration_round_trip(tmp_path):
    p = tmp_path / "v1.json"
    p.write_text(json.dumps({"version": 1, "entries": {
        "4096/64/2": {"best": 2, "measured_us": {"1": 900.0, "2": 500.0}},
        "4096/128/2": {"best": 4, "measured_us": {"1": 800.0, "4": 420.0}}}}))
    loaded = autotune.SplitProfile.load(p)
    assert loaded.lookup(4096, 64, 2) == 2 and loaded.lookup(4096, 128, 2) == 4
    assert loaded.lookup_config(4096, 2) == SC(4, 128)
    p2 = tmp_path / "v2.json"
    loaded.save(p2)
    assert json.loads(p2.read_text())["version"] == 2
    again = autotune.SplitProfile.load(p2)
    assert again.lookup_config(4096, 2) == SC(4, 128) and again.entries == loaded.entries


def test_reference_profile_loads_with_equal_plans(tmp_path):
    """A file the reference's ``SplitProfile`` wrote resolves to the same
    plans in the port (the formats are one)."""
    j = jautotune.SplitProfile()
    j.record(32768, 128, 4, {1: 900.0, 4: 400.0, 8: 410.0})
    j.record(32768, 64, 4, {1: 950.0, 2: 500.0})
    j.record(640, 128, 2, {1: 40.0, 2: 30.0}, layout="paged")
    j.record(640, 128, 2, {1: 40.0, 4: 20.0}, layout="paged", rescale="amla")
    j.record(4096, 128, 16, {1: 100.0, 8: 60.0})
    p = j.save(tmp_path / "reference.json")
    t = autotune.SplitProfile.load(p)
    assert t.entries == j.entries
    for cap, bn in ((32768, 128), (32768, 64), (640, 128), (4096, 128)):
        for batch in (1, 2, 4, 16, 64, None):
            for layout in ("contiguous", "paged"):
                for rescale in ("fma", "amla"):
                    args = (cap, bn, batch, layout, rescale)
                    assert t.lookup_nearest(*args) == j.lookup_nearest(*args), args
                    tc = t.lookup_config(cap, batch, layout, rescale)
                    jc = j.lookup_config(cap, batch, layout, rescale)
                    assert (tc is None and jc is None) or tuple(tc) == tuple(jc), args


def test_lookup_config_across_block_n_batches_and_layouts():
    profile = autotune.SplitProfile()
    profile.record(8192, 64, 4, {1: 700.0, 2: 300.0})
    profile.record(8192, 128, 4, {1: 600.0, 4: 250.0})
    profile.record(8192, 256, 4, {1: 900.0})
    assert profile.lookup_config(8192, 4) == SC(4, 128)
    profile.record(8192, 32, 4, {2: 250.0})
    assert profile.lookup_config(8192, 4) == SC(2, 32)               # time tie: smaller bn
    profile.entries["8192/16/4"] = {"best": "garbage", "best_us": 1.0}
    profile.entries["8192/8/4"] = {"best_us": 1.0}
    assert profile.lookup_config(8192, 4) == SC(2, 32)
    assert profile.lookup_config(8192, None) is None
    near = autotune.SplitProfile()
    near.record(8192, 64, 2, {1: 500.0, 2: 400.0})
    near.record(8192, 128, 64, {1: 300.0, 8: 100.0})
    assert near.lookup_config(8192, 4) == SC(2, 64)
    assert near.lookup_config(8192, 32) == SC(8, 128)
    near.record(8192, 128, 4, {4: 50.0}, layout="paged")
    assert near.lookup_config(8192, 4) == SC(2, 64)
    assert near.lookup_config(8192, 4, layout="paged") == SC(4, 128)
    assert near.lookup_config(4096, 4) is None


def test_resolve_split_config_auto_block_n_and_paged_pin():
    profile = autotune.SplitProfile()
    profile.record(4096, 64, 2, {1: 900.0, 2: 500.0})
    profile.record(4096, 128, 2, {1: 800.0, 4: 420.0})
    profile.record(4096, 64, 2, {1: 900.0, 4: 300.0}, layout="paged")
    autotune.reset(profile)
    assert resolve_split_config(None, None, 4096, batch=2) == SC(4, 128)
    assert resolve_split_config(None, 64, 4096, batch=2) == SC(2, 64)
    assert resolve_split_config(2, None, 4096, batch=2) == SC(2, 128)
    assert ops.DEFAULT_BLOCK_N == 128
    assert resolve_split_config(None, None, 4096 + 64, batch=2).block_n == 64
    assert resolve_split_config(None, None, 4096, batch=2, layout="paged",
                                page_size=64) == SC(4, 64)
    with pytest.raises(ValueError):
        resolve_split_config(None, 128, 4096, batch=2, layout="paged", page_size=64)
    with pytest.raises(ValueError):
        resolve_split_config(None, None, 4096, batch=2, layout="paged")


def test_candidates():
    assert autotune.candidate_splits(64, 128) == [1]
    assert autotune.candidate_splits(256, 128) == [1, 2]
    assert autotune.candidate_splits(131072, 128) == [1, 2, 4, 8]
    assert autotune.candidate_block_ns(4096) == [32, 64, 128, 256]
    assert autotune.candidate_block_ns(96) == [32]
    assert autotune.candidate_block_ns(20) == [20]
    assert autotune.block_ns_for_paged(4096) == 128 and autotune.block_ns_for_paged(64) == 64


@pytest.mark.parametrize("layout,rescale,timings,best", [
    ("contiguous", "fma", {1: 100.0, 2: 80.0, 4: 79.0}, 2),
    ("contiguous", "fma", {1: 100.0, 2: 97.0, 4: 99.0}, 1),
    ("contiguous", "amla", {1: 300.0, 2: 200.0, 4: 100.0}, 4),
    ("paged", "fma", {1: 300.0, 2: 200.0, 4: 100.0}, 4)])
def test_measure_split_sweep_records_its_key_only(layout, rescale, timings, best):
    """A synthetic timer runs nothing (no cache is built, no device asked
    for) and the sweep records under its own layout / rescale key."""
    profile = autotune.SplitProfile()
    measured = autotune.measure_split_sweep(
        128, 32, 1, d_c=16, d_r=8, heads=2, profile=profile, layout=layout,
        rescale=rescale, timer=autotune.synthetic_timer(timings))
    assert measured == timings
    assert profile.lookup(128, 32, 1, layout=layout, rescale=rescale) == best
    assert len(profile.entries) == 1


def test_measure_config_sweep_synthetic_2d():
    profile = autotune.SplitProfile()
    grid = {(32, 1): 200.0, (32, 2): 120.0, (32, 4): 110.0, (64, 1): 180.0, (64, 2): 90.0}
    measured = autotune.measure_config_sweep(128, 1, block_ns=[32, 64], d_c=16, d_r=8,
                                             heads=2, profile=profile,
                                             timer=autotune.synthetic_timer_2d(grid))
    assert measured == grid
    assert profile.lookup(128, 32, 1) == 4 and profile.lookup(128, 64, 1) == 2
    assert profile.lookup_config(128, 1) == SC(2, 64)
    paged = autotune.SplitProfile()
    m = autotune.measure_config_sweep(128, 1, d_c=16, d_r=8, heads=2, profile=paged,
                                      layout="paged",
                                      timer=autotune.synthetic_timer_2d({(128, 1): 100.0}))
    assert set(m) == {(128, 1)}
    assert paged.lookup_config(128, 1, layout="paged") == SC(1, 128)
    assert paged.lookup_config(128, 1) is None


def test_the_card_timer_refuses_the_cpu(monkeypatch):
    """Without a card the default timer raises; nothing falls back to a CPU
    clock."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        autotune.measure_split_sweep(128, 32, 1, d_c=16, d_r=8, heads=2,
                                     profile=autotune.SplitProfile())


def test_sweep_runner_decodes_on_the_cpu_when_asked():
    """``run`` builds its case on the device the caller names and decodes
    at the swept split count; timed by a stub that runs it once."""
    seen = {}

    def timer(s, run):
        o, lse = run()
        seen[s] = o
        return float(s)
    autotune.measure_split_sweep(128, 32, 2, d_c=16, d_r=8, heads=2,
                                 profile=autotune.SplitProfile(), timer=timer, device="cpu")
    assert set(seen) == {1, 2, 4}
    for o in seen.values():
        assert o.shape == (2, 2, 16) and torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), seen[1].numpy(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("name", ["torch_ref", "cuda_splitkv", "torch_paged_ref",
                                  "cuda_paged_splitkv"])
def test_backends_resolve_with_batch_layout_and_rescale(name, monkeypatch):
    """Each backend asks the profile for (capacity, block_n, batch) under its
    layout and the config's rescale, as the reference's backends do."""
    calls = []
    real = autotune.tuned_num_splits

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(autotune, "tuned_num_splits", spy)
    paged = "paged" in name
    from repro_torch.core.kvcache import CacheConfig, init_mla_cache, init_paged_mla_cache
    cfg = CacheConfig(fmt="fp8_e4m3", page_size=16)
    init = init_paged_mla_cache if paged else init_mla_cache
    cache = init(cfg, 3, 64, 16, 8, device="cpu")
    cache = cache._replace(seq_lens=torch.tensor([5, 20, 64], dtype=torch.int32))
    q = TB.DecodeQuery.raw(torch.randn(3, 2, 16), torch.randn(3, 2, 8))
    bcfg = TB.BackendConfig(softmax_scale=0.1, block_n=16, rescale="amla")
    TB.get_backend(name).decode(q, cache, bcfg)
    assert calls and calls[0] == (64, 16, 3, "paged" if paged else "contiguous", "amla")
