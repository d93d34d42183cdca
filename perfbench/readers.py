"""What the per-layer metric files (``metrics/<name>.py``) read, and the
probes they run in a traced run while the program is alive.

The probes copy the program's ``utils/profiler.py`` arithmetic: a stage's
time is the difference of nested prefixes of the eval forward (coarse
only, + flow1, + flow2, + flow3), each the median of 5 synchronized calls
after one warm-up; the train step's forward is the loss forward without
gradient and its backward the forward-with-backward less that. A reader
that finds nothing to read returns None and the metric is left out of the
result.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perfbench.counts import bounds, flops
from perfbench.drivers.common import forward_kwargs


def _timed(fn: Callable, device: torch.device, iters: int = 5) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def stage_latencies(model, images, cams, kwargs: Dict) -> Dict[str, float]:
    scales, inter = kwargs["img_scales"], kwargs["inter_scales"]

    def prefix(n: int):
        kw = dict(kwargs, is_flow=n > 0, img_scales=tuple(scales[:n]),
                  inter_scales=tuple(inter[:n]))

        def run():
            with torch.inference_mode():
                model(images, cams, **kw)
        return run

    model.eval()
    out, prev = {}, _timed(prefix(0), images.device)
    out["coarse_s"] = prev
    for n in range(1, len(scales) + 1):
        cur = _timed(prefix(n), images.device)
        out[f"flow{n}_s"] = cur - prev
        prev = cur
    return out


def collect_stages(run) -> None:
    model, images, cams, kwargs = run.driver.probe_inputs()
    run.once("stages", lambda: stage_latencies(model, images, cams, kwargs))


def stage_ms(run, stage: str) -> Optional[float]:
    stages = run.memo.get("stages")
    return None if stages is None else stages[f"{stage}_s"] * 1e3


def collect_train_stages(run) -> None:
    d = run.driver
    model, batch = d.state.model, d.batches[0]

    def loss():
        preds = model(batch["images"], batch["cams"], **d.kwargs)
        return d.loss_fn(preds, batch["gt_depth"], batch["cams"])["total_loss"]

    def forward():
        with torch.no_grad():
            loss()

    def grad():
        model.zero_grad(set_to_none=True)
        loss().backward()

    def measure():
        model.train()
        fwd = _timed(forward, d.device)
        return {"forward_s": fwd, "backward_s": _timed(grad, d.device) - fwd}

    run.once("train_stages", measure)


def train_ms(run, part: str) -> Optional[float]:
    stages = run.memo.get("train_stages")
    return None if stages is None else stages[f"{part}_s"] * 1e3


# ---------------------------------------------------------- from the trace

def idle_pct(run) -> Optional[float]:
    """Share of the traced window with no operation on the device, the
    window less its ``wait`` spans (the time the program has work)."""
    rec = run.record
    if rec is None or rec.active_s <= 0 or not rec.ops:
        return None
    return 100.0 * (1.0 - rec.active_busy_s / rec.active_s)


def launches_per_item(run) -> Optional[float]:
    rec = run.record
    if rec is None or rec.items == 0 or not rec.ops:
        return None
    return rec.kernels() / rec.items


def host_ms(run) -> Optional[float]:
    """Mean over the traced run's requests of the request's host time less
    its synchronized model call."""
    rec = run.record
    if rec is None or not rec.host.get("request_s"):
        return None
    req, mod = rec.host["request_s"], rec.host["model_call_s"]
    return float(np.mean(np.asarray(req) - np.asarray(mod))) * 1e3


def _flow_grids(run):
    b = run.cell.config["eval"]
    m = run.cell.config["model"]
    g = 2 * m["FLOW_INTERVAL_M"] + 1
    return [(g, int(b["height"] * s), int(b["width"] * s)) for s in b["img_scales"]]


def knn_roofline(run) -> Optional[float]:
    """The kNN's least time per map at the cell's flow grids over the
    CUPTI time of the kernels named ``window_knn*`` per traced map."""
    rec = run.record
    if rec is None or rec.items == 0:
        return None
    measured = rec.kernel_seconds("window_knn") / rec.items
    if measured <= 0:
        return None
    m = run.cell.config["model"]
    least = sum(bounds.bound_ms(*bounds.knn_bound(h, w, g, m["KNN"], m["KNN_WINDOW"]))[0]
                for g, h, w in _flow_grids(run)) / 1e3
    return 100.0 * least / measured


def mwm_roofline(run) -> Optional[float]:
    """The masked max's least time per map (each flow grid's three EdgeConv
    widths, on the set bits of the reference's kNN masks for the same
    scenes) over the CUPTI time of ``masked_window_max*`` kernels per
    traced map."""
    rec, bits = run.record, run.memo.get("mask_bits")
    if rec is None or rec.items == 0 or not bits:
        return None
    measured = rec.kernel_seconds("masked_window_max") / rec.items
    if measured <= 0:
        return None
    m = run.cell.config["model"]
    esize = torch.finfo(getattr(torch, run.cell.config["eval"]["dtype"])).bits // 8
    least = 0.0
    for g, h, w in _flow_grids(run):
        words = -(-(g * m["KNN_WINDOW"] ** 2) // 32) * g * h * w
        for f in m["EDGE_CHANNELS"]:
            least += bounds.bound_ms(*bounds.mwm_bound(g * h * w, f, esize, words,
                                                       bits[(g, h, w)]))[0] / 1e3
    return 100.0 * least / measured


def mfu(run) -> Optional[float]:
    """Operations per item (an eval forward, or a train step for the
    ``train`` driver), each at its dtype's peak, times the traced items,
    over the traced window less its ``wait`` spans."""
    rec = run.record
    if rec is None or rec.active_s <= 0 or not rec.ops:
        return None
    cfg = run.cell.config
    train = run.cell.traffic["driver"] == "train"
    b = cfg["train" if train else "eval"]

    def count():
        if train:
            return flops.train_step_flops(cfg["model"], b["dtype"], b["batch"], b["views"],
                                          b["height"], b["width"], forward_kwargs(b),
                                          cfg["model"]["VALID_THRESHOLD"])
        return flops.forward_flops(cfg["model"], b["dtype"], b["views"], b["height"],
                                   b["width"], forward_kwargs(b))
    return 100.0 * rec.items * flops.peak_seconds(run.once("flops", count)) / rec.active_s
