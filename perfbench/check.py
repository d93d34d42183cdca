"""The comparisons that decide ``correct``: the numbers compared, each
worked out from the program's outputs (or a control's) and the plain
reference's on the same inputs.

Eval outputs (``map_numbers``): for each map the program returns (coarse
depth and confidence, flow1-3), the mean |program − f32 reference| over
the mean |reference in the configuration's precision − f32 reference|:
how many times the rounding of the stated precision the program's answer
is off. The scale is worked out anew for every scene, since how far a
precision's rounding carries through a network depends on its weights
(the absolute gap of the bf16 program swung 5x from seed to seed on the
card). The largest over the answers compared.

Each PointFlow iteration by itself (``step_numbers``): the same ratio for
``flowN``, where both references start iteration N from the program's own
``flowN_input``. The error a flow inherits from the stages before it
(which the maps above hold) then drops out, and what is left is the
iteration's own: the fetch, the kNN, EdgeConv with the masked max and the
head.

Training (``compare_steps``): the first step's total loss as a share of
the reference's; and, by the worst leaf, the gap between the program's
and the reference's norm of (a) the first gradient as the optimizer gets
it (weight decay added), worked out from RMSprop's ν after one step, (b)
the parameters' change over three steps, (c) the BatchNorm running
statistics' change over the first step; each gap over the larger of the
reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's (the final conv's
bias under the depth softmax, the head's bias under the hypothesis
softmax) move by round-off alone and are left out of (b). Later steps'
losses and statistics are not compared: on the card the f32 reference
read against itself differs there as much as the program does
(``perfbench/tools/readings.py --what self``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

MAP_KEYS = ("coarse_depth_map", "coarse_prob_map", "flow1", "flow2", "flow3")
SHORT = {"coarse_depth_map": "coarse_depth", "coarse_prob_map": "coarse_prob"}
FLOWS = ("flow1", "flow2", "flow3")
# what a driver keeps of each answer: the maps compared and each flow's input
KEPT = (*MAP_KEYS, *(f"{f}_input" for f in FLOWS))
NEGLIGIBLE_GRAD = 1e-3


def _ratio(cand, ref, scale) -> float:
    r = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(cand, np.float64) - r).mean()
                 / np.abs(np.asarray(scale, np.float64) - r).mean())


def map_numbers(cand: Mapping[str, np.ndarray], ref: Mapping[str, np.ndarray],
                scale: Mapping[str, np.ndarray]) -> Dict[str, float]:
    """mean |cand − ref| / mean |scale − ref| per map: ``ref`` the f32
    reference's outputs, ``scale`` the reference's in the configuration's
    precision."""
    return {SHORT.get(k, k): _ratio(cand[k], ref[k], scale[k]) for k in MAP_KEYS if k in ref}


def step_numbers(cand: Mapping[str, np.ndarray], ref: Mapping[str, np.ndarray],
                 scale: Mapping[str, np.ndarray]) -> Dict[str, float]:
    """As ``map_numbers`` for each flow, the references having started
    each iteration from ``cand``'s ``flowN_input``."""
    return {f"{f}_step": _ratio(cand[f], ref[f], scale[f]) for f in FLOWS if f in ref}


def worst(numbers: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over several answers (NaN wins)."""
    out: Dict[str, float] = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = v if (k not in out or not v <= out[k]) else out[k]
    return out


def leaf_gap(cand: Mapping[str, float], ref: Mapping[str, float],
             names: Iterable[str] | None = None) -> float:
    names = list(ref) if names is None else list(names)
    floor = float(np.median([ref[n] for n in ref]))
    return max(abs(cand[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names)


class StepSummary:
    """What a training run's first three steps leave to compare: each
    step's total loss, and per leaf the norms of the first gradient as the
    optimizer gets it, of each parameter's change over the three steps and
    of each running statistic's change over the first."""

    def __init__(self, losses: List[float], grad: Dict[str, float],
                 change: Dict[str, float], stats: Dict[str, float]):
        self.losses, self.grad, self.change, self.stats = losses, grad, change, stats


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def changes(before: Mapping[str, torch.Tensor], after: Mapping[str, torch.Tensor]):
    return norms({n: after[n].double() - before[n].double() for n in before})


def compare_steps(cand: StepSummary, ref: StepSummary,
                  ref_raw_grad: Mapping[str, float]) -> Dict[str, float]:
    floor = float(np.median(list(ref_raw_grad.values())))
    moved = [n for n, g in ref_raw_grad.items() if g >= NEGLIGIBLE_GRAD * floor]
    return {
        "loss": abs(cand.losses[0] - ref.losses[0]) / abs(ref.losses[0]),
        "grad": leaf_gap(cand.grad, ref.grad),
        "change": leaf_gap(cand.change, ref.change, moved),
        "bn_stats": leaf_gap(cand.stats, ref.stats),
    }


def leaf_detail(cand: StepSummary, ref: StepSummary, top: int = 3) -> Dict:
    """The steps' losses and, for each per-leaf number, its worst leaves
    and its median leaf's gap (for the readings that set the limits)."""
    out: Dict = {"losses": [cand.losses, ref.losses]}
    for key in ("grad", "change", "stats"):
        c, r = getattr(cand, key), getattr(ref, key)
        floor = float(np.median(list(r.values())))
        gaps = sorted(((abs(c[n] - r[n]) / max(r[n], floor, 1e-30), n, c[n], r[n])
                       for n in r), reverse=True)
        out[key] = {"median_gap": float(np.median([g[0] for g in gaps])),
                    "worst": [list(g) for g in gaps[:top]]}
    return out
