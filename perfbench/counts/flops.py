"""Operations of the reference's forward and train step at a cell's
shapes, by the dtype of their operands, counted on the meta device with
``torch.utils.flop_counter``'s formulas (matmuls and convolutions; the
element-wise work is left out, as it is from every model-FLOPs figure).

The reference is run in the precision the configuration states ("bf16"
casts every conv and matmul operand to bfloat16 as the program's bf16
config does), so each operation is counted at the peak of its own dtype.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from perfbench.counts.bounds import PEAK_FLOPS
from perfbench.reference import model as ref
from perfbench.reference.train import RMSprop, depth_loss


class DtypeFlops(TorchDispatchMode):
    """Counts the operations of every op with a flop formula, keyed by the
    dtype of its first tensor operand."""

    def __init__(self):
        super().__init__()
        self.by_dtype: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
            self.by_dtype[str(dtype).removeprefix("torch.")] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        return out


def peak_seconds(by_dtype: Dict[str, float]) -> float:
    """Σ operations / the peak of their dtype."""
    return sum(n / PEAK_FLOPS[d] for d, n in by_dtype.items())


def _meta_inputs(batch: int, views: int, height: int, width: int):
    images = torch.empty(batch, views, height, width, 3, device="meta")
    cams = torch.empty(batch, views, 2, 4, 4, device="meta")
    return images, cams


def forward_flops(model_cfg: Dict, dtype: str, views: int, height: int, width: int,
                  kwargs: Dict) -> Dict[str, float]:
    """One eval forward at B = 1 → {operand dtype: operations}."""
    with torch.device("meta"):
        net = ref.build(model_cfg, ref.PRECISION_OF[dtype]).eval()
    images, cams = _meta_inputs(1, views, height, width)
    counter = DtypeFlops()
    with counter, torch.no_grad():
        net(images, cams, **kwargs)
    return dict(counter.by_dtype)


def train_step_flops(model_cfg: Dict, dtype: str, batch: int, views: int, height: int,
                     width: int, kwargs: Dict, valid_threshold: float) -> Dict[str, float]:
    """One train step (forward, loss, backward, RMSprop) at ``batch`` →
    {operand dtype: operations}. The backward's recompute of EdgeConv's
    gather holds no matmul, so nothing is counted twice."""
    with torch.device("meta"):
        net = ref.build(model_cfg, ref.PRECISION_OF[dtype]).train()
    images, cams = _meta_inputs(batch, views, height, width)
    gt = torch.empty(batch, height, width, 1, device="meta")
    opt = RMSprop(net, 1e-3, 0.0, 0.9, 1e-8)
    counter = DtypeFlops()
    with counter:
        preds = net(images, cams, **kwargs)
        depth_loss(preds, gt, cams, valid_threshold)["total_loss"].backward()
        opt.step()
    return dict(counter.by_dtype)
