"""The whole CasMVSNet forward's share of the card's peak, %: the
operations of the plain reference's forward at the cell's shapes
(``reference/casmvsnet.py`` on the meta device in the configuration's
precision, counted by ``counts/flops.py::DtypeFlops``, each at its
operand dtype's peak) times the traced maps, over the traced window.
The reference's few float64 operations (the 4 × 4 products of its
homographies) are counted at the f32 peak."""
from typing import Optional

import torch

from perfbench.counts.flops import DtypeFlops, peak_seconds
from perfbench.reference import casmvsnet as ref
from perfbench.reference.model import PRECISION_OF


def forward_flops(config):
    """One forward at B = 1 → {operand dtype: operations}."""
    b = config["eval"]
    with torch.device("meta"):
        net = ref.build(config["model"], PRECISION_OF[b["dtype"]]).eval()
    images, cams = ref.flops_inputs(b["views"], b["height"], b["width"])
    counter = DtypeFlops()
    with counter, torch.no_grad():
        net(images, cams, b["num_depth"])
    out = dict(counter.by_dtype)
    out["float32"] = out.get("float32", 0.0) + out.pop("float64", 0.0)
    return out


def read(run) -> Optional[float]:
    rec = run.record
    if rec is None or rec.active_s <= 0 or not rec.ops:
        return None
    ops = run.once("flops", lambda: forward_flops(run.cell.config))
    return 100.0 * rec.items * peak_seconds(ops) / rec.active_s
