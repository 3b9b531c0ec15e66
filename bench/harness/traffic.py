"""Traffic generators, driven by the parameters of a workload file. Every seed
gets the same set of sizes (stratified over the stated range) in another
order, so seeds change the data and not the amount of work."""
from __future__ import annotations

import numpy as np

from harness.common import sub_seed


def stratified(dist: dict, n: int) -> np.ndarray:
    """``n`` sizes at the midpoints of ``n`` equal-probability strata of
    ``dist``, ``{"kind": "uniform", "lo", "hi"}``."""
    if dist["kind"] != "uniform":
        raise ValueError(f"unknown size distribution {dist['kind']!r}")
    u = (np.arange(n) + 0.5) / n
    x = dist["lo"] + u * (dist["hi"] - dist["lo"])
    return np.clip(np.rint(x), dist["lo"], dist["hi"]).astype(np.int64)


def permuted(values: np.ndarray, seed: int, purpose: str) -> np.ndarray:
    return np.random.default_rng(sub_seed(seed, purpose)).permutation(values)


def decode_contexts(wl: dict, seed: int) -> np.ndarray:
    """Each row's context length for an offline decode cell."""
    return permuted(stratified(wl["context"], wl["batch"]), seed, "contexts")


def pick(n: int, k: int, seed: int, purpose: str, always=()) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed, ``always`` included, sorted."""
    rng = np.random.default_rng(sub_seed(seed, purpose))
    chosen = set(int(a) for a in always)
    rest = [i for i in rng.permutation(n).tolist() if i not in chosen]
    chosen.update(rest[:max(k - len(chosen), 0)])
    return sorted(chosen)
