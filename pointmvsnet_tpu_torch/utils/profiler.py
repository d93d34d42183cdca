"""Per-stage latencies and tracing: counterpart of
``pointmvsnet_tpu/utils/profiler.py``.

* ``stage_latencies`` times nested prefixes of the eval forward
  (coarse-only, + flow1, + flow2, ...) and differences them: each delta is
  the marginal cost of one PointFlow iteration, its image pyramid
  included. Under an eval grid every rank of the model's band and view
  groups calls it together.
* ``train_stage_latencies`` does the same for a train step: forward,
  backward, optimizer, and the coarse-only step against the whole one.
* ``trace`` records the enclosed block with ``torch.profiler``.

Each timed call ends in ``torch.cuda.synchronize`` on the card (host
timing of the finished work on the CPU); a time is the median of
``iters`` calls after one warm-up call, in seconds.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch


def _timed(fn: Callable[[], Any], device: torch.device, iters: int = 5) -> float:
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


def stage_latencies(model: torch.nn.Module, images: torch.Tensor, cams: torch.Tensor,
                    img_scales: Sequence[float], inter_scales: Sequence[float],
                    num_virtual_plane: int, iters: int = 5) -> Dict[str, float]:
    """Eval forward (``model`` in eval mode, no gradient) on ``images`` /
    ``cams`` → {"coarse_s", "flow1_iter_s", ..., "total_s"}."""
    def make(n_flow: int):
        kwargs = dict(is_flow=n_flow > 0, img_scales=tuple(img_scales[:n_flow]),
                      inter_scales=tuple(inter_scales[:n_flow]),
                      num_virtual_plane=num_virtual_plane)

        def run():
            with torch.inference_mode():
                return model(images, cams, **kwargs)
        return run

    model.eval()
    out: Dict[str, float] = {}
    prev = _timed(make(0), images.device, iters)
    out["coarse_s"] = prev
    for n in range(1, len(img_scales) + 1):
        cur = _timed(make(n), images.device, iters)
        out[f"flow{n}_iter_s"] = cur - prev
        prev = cur
    out["total_s"] = prev
    return out


def train_stage_latencies(state, loss_fn: Callable, batch: Dict[str, torch.Tensor],
                          model_kwargs: Dict[str, Any], iters: int = 5) -> Dict[str, float]:
    """Train-step decomposition by differencing nested prefixes, for a
    ``parallel.TrainState`` on ``batch``: fwd_s (the loss forward, no
    gradient), bwd_s (forward + backward − fwd_s), step_s (the whole
    ``make_train_step`` step), opt_s (step_s − forward + backward),
    coarse_step_s (the step with ``is_flow=False``) and flow_step_s
    (step_s − coarse_step_s). The timed calls update parameters, optimizer
    state and BatchNorm statistics; all of them, and the step counter,
    are put back afterwards."""
    from pointmvsnet_tpu_torch.parallel.train_step import make_train_step

    model, opt = state.model, state.optimizer
    saved = ({k: v.clone() for k, v in model.state_dict().items()}, opt.state_dict(),
             state.step, model.training)
    dev = batch["images"].device

    def loss():
        preds = model(batch["images"], batch["cams"], **model_kwargs)
        return loss_fn(preds, batch["gt_depth"], batch["cams"])["total_loss"]

    def forward():
        with torch.no_grad():
            loss()

    def grad():
        model.zero_grad(set_to_none=True)
        loss().backward()

    coarse = dict(model_kwargs, is_flow=False, img_scales=(), inter_scales=())
    try:
        model.train()
        out: Dict[str, float] = {"fwd_s": _timed(forward, dev, iters)}
        grad_s = _timed(grad, dev, iters)
        out["bwd_s"] = grad_s - out["fwd_s"]
        step = make_train_step(loss_fn, model_kwargs)
        out["step_s"] = _timed(lambda: step(state, batch), dev, iters)
        out["opt_s"] = out["step_s"] - grad_s
        coarse_step = make_train_step(loss_fn, coarse)
        out["coarse_step_s"] = _timed(lambda: coarse_step(state, batch), dev, iters)
        out["flow_step_s"] = out["step_s"] - out["coarse_step_s"]
    finally:
        model.load_state_dict(saved[0])
        opt.load_state_dict(saved[1])
        state.step = saved[2]
        model.zero_grad(set_to_none=True)
        model.train(saved[3])
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the enclosed block (the card's kernels too
    where there is one) → ``log_dir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
