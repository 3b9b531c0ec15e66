"""The comparison that decides ``correct``: served tokens and logits of the
program against the plain reference's logits at the same positions."""
from __future__ import annotations

import torch


def gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each served token's
    reference logit lies: ref [..., V], served [...] -> [...]."""
    return ref.amax(-1) - ref.gather(-1, served.long()[..., None])[..., 0]


def excess(ref: torch.Tensor, prog: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far the served token's reference logit lies below the reference's
    best beyond what the program's own logits allow: a greedy token t of the
    program's logits p (p[t] >= p[b], b the reference's best) lies at most
    |r[b] - p[b]| + |p[t] - r[t]| below r[b]. Worked in float64 from float32
    logits, where each of these differences is exact, so a greedy token reads
    exactly 0 however far the program's logits round from the reference's,
    and a token altered after its logits reads above 0: [..., V] -> [...]."""
    r, p = ref.double(), prog.double()
    b = r.argmax(-1, keepdim=True)
    t = served.long()[..., None]
    gap = r.gather(-1, b) - r.gather(-1, t)
    room = (r.gather(-1, b) - p.gather(-1, b)).abs() + (p.gather(-1, t) - r.gather(-1, t)).abs()
    return (gap - room).clamp(min=0)[..., 0]


def deviations(ref: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """The widest logit difference at each position, as a share of the
    reference logits' spread there (their standard deviation over the
    vocabulary): [..., V] -> [...]."""
    return (other.float() - ref).abs().amax(-1) / ref.std(-1)


def readings(ref: torch.Tensor, prog: torch.Tensor, served: torch.Tensor) -> dict:
    """The numbers a cell may compare, over every position compared: the
    mean gap of the served token below the reference's best (logit units),
    the widest ``excess`` of a served token (exactly 0 for a greedy token of
    the logits the program returned), and the mean of the widest logit
    deviation as a share of the logits' spread. The gap and the deviation
    are means because their maxima swing with the rare position where a
    near-tie (of two logits, or of the MoE router's k-th and next expert)
    falls the other way on a numerical difference; a fault or a lower
    precision moves the means. Such a flip moves the gap's mean too, by a
    whole gap at one position."""
    return {"token_gap_mean": float(gaps(ref, served).mean()),
            "token_excess_max": float(excess(ref, prog, served).max()),
            "logit_dev_mean": float(deviations(ref, prog).mean())}


def control_readings(ref: torch.Tensor, low: torch.Tensor) -> dict:
    """The same numbers for the reference computed one precision lower and
    put in the program's place: its greedy token at each position."""
    return readings(ref, low, low.argmax(-1))


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, value, limit)])."""
    compared = [(name, values[name], float(limits[name])) for name in sorted(limits)]
    return all(v <= lim for _, v, lim in compared), compared


def spread(ref: torch.Tensor, other: torch.Tensor, served: torch.Tensor) -> dict:
    """How the per-position numbers spread (a look at where a maximum comes
    from): quantiles of the relative deviation, and the count and largest
    of the non-zero gaps."""
    dev = deviations(ref, other).flatten().float()
    gap = gaps(ref, served).flatten()
    q = torch.quantile(dev, torch.tensor([0.5, 0.9, 0.99], device=dev.device)).tolist()
    return {"dev_mean": float(dev.mean()), "dev_p50": q[0], "dev_p90": q[1], "dev_p99": q[2],
            "dev_max": float(dev.max()),
            "positions": dev.numel(), "gaps_nonzero": int((gap > 0).sum()),
            "gap_mean": float(gap.mean()), "gap_max": float(gap.max())}

