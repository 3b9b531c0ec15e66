"""The traffic generators: deterministic per seed, the same sizes for every
seed in another order."""
import numpy as np
import pytest

import bench_smoke_cases as S  # noqa: F401  (puts bench/ on the path)
from harness import traffic

SEEDS = (1, 2**31 + 7, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_contexts_repeat_per_seed(seed):
    wl = {"batch": 64, "context": {"kind": "uniform", "lo": 16384, "hi": 32768}}
    a, b = traffic.decode_contexts(wl, seed), traffic.decode_contexts(wl, seed)
    assert np.array_equal(a, b)
    assert a.min() >= 16384 and a.max() <= 32768


def test_decode_contexts_same_set_across_seeds():
    wl = {"batch": 64, "context": {"kind": "uniform", "lo": 512, "hi": 2048}}
    sets = [np.sort(traffic.decode_contexts(wl, s)) for s in SEEDS]
    orders = [traffic.decode_contexts(wl, s) for s in SEEDS]
    assert all(np.array_equal(sets[0], x) for x in sets)
    assert not np.array_equal(orders[0], orders[1])


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        traffic.stratified({"kind": "lognormal", "median": 512, "lo": 128, "hi": 2048}, 8)


def test_pick_keeps_what_is_asked():
    got = traffic.pick(128, 4, 9, "offsets", always=[127])
    assert 127 in got and len(got) == 4 and got == sorted(got)
    assert got == traffic.pick(128, 4, 9, "offsets", always=[127])
