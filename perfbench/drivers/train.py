"""Train: the program's train step (``parallel/train_step.py::
make_train_step``) run back to back on batches already on the card.

Traffic keys: ``batches`` batches of the config's batch size made from the
seed (every sample a scene of its own), cycled; ``plane_fracs`` where the
scene's planes lie in the hypothesis range. Set-up builds one train state
and drives it through its first three steps, on batches 0-2, with the
window's own call: those steps warm up the shapes and leave what the
reference is compared on (each step's loss, RMSprop's ν and the running
statistics after the first step, the parameters after the third). The
window goes on from that same state.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from perfbench import inputs
from perfbench.check import StepSummary, changes, compare_steps, norms
from perfbench.drivers import common
from perfbench.reference.model import request_inputs
from perfbench.reference.train import RMSprop, train_step

FOLLOWED = 3          # steps the reference follows


def make_batches(seed: int, block: Dict, traffic: Dict, device) -> list:
    """``traffic["batches"]`` batches of ``block["batch"]`` scenes on
    ``device``: images normalized, cams, true depth (B, H, W, 1)."""
    b = block
    pool = inputs.scene_pool(seed, traffic["batches"] * b["batch"], b["views"], b["height"],
                             b["width"], b["num_depth"], traffic.get("plane_fracs", (0.25, 0.70)))
    out = []
    for i in range(traffic["batches"]):
        part = pool[i * b["batch"]:(i + 1) * b["batch"]]
        images = torch.cat([request_inputs(fr, c)[0] for fr, c, _ in part])
        out.append({"images": images.to(device),
                    "cams": torch.from_numpy(np.stack([c for _, c, _ in part])).to(device),
                    "gt_depth": torch.from_numpy(np.stack([d for _, _, d in part])[..., None])
                    .to(device)})
    return out


def stats_of(model) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from pointmvsnet_tpu_torch import disable_tf32
        from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
        from pointmvsnet_tpu_torch.parallel.train_step import TrainState, make_train_step
        from pointmvsnet_tpu_torch.utils.solver import build_optimizer

        self.cell, self.device = cell, device
        self.block = b = cell.config["train"]
        self.batches = make_batches(seed, b, cell.traffic, device)
        self.weights = common.seeded_weights(cell.config, seed, device)
        cfg = common.program_cfg(cell.config, "train")
        model = build_model(cfg, device)
        disable_tf32()
        model.load_state_dict(self.weights)
        steps_per_epoch = -(-b["samples_per_epoch"] // b["batch"])
        self.state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()),
                                                       steps_per_epoch))
        self.kwargs = common.forward_kwargs(b)
        self.loss_fn = build_loss_fn(cfg)
        self.step = make_train_step(self.loss_fn, self.kwargs)
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        stats0 = stats_of(model)
        losses = []
        for i in range(FOLLOWED):
            _, out = self.step(self.state, self.batches[i])
            losses.append(float(out["total_loss"]))
            if i == 0:
                nu = {n: s["nu"] for n, s in self.state.optimizer.slots.items()}
                alpha = self.state.optimizer.alpha
                grad = {n: float((v.double() / (1 - alpha)).sum().sqrt()) for n, v in nu.items()}
                stats = changes(stats0, stats_of(model))
        self.summary = StepSummary(
            losses, grad,
            changes(params0, {n: p.detach() for n, p in model.named_parameters()}), stats)

    def window(self, seconds: float, tracer) -> Dict:
        skipped0, n = self.state.optimizer.skipped_steps, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tracer.item(n), tracer.span("step"):
                self.step(self.state, self.batches[(n + FOLLOWED) % len(self.batches)])
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        failed = self.state.optimizer.skipped_steps - skipped0
        return {"values": {"train_samples_per_s": n * self.block["batch"] / (t_end - t0)},
                "attempted": n, "failed": failed}

    def free(self) -> None:
        del self.state, self.step

    def check(self, memo: Dict) -> Dict[str, float]:
        ref, raw = reference_steps(self.cell.config, self.weights, self.batches, self.kwargs,
                                   self.device)
        memo["reference_steps"] = ref
        return compare_steps(self.summary, ref, raw)


def reference_steps(config: Dict, weights, batches, kwargs, device, precision: str = "f32",
                    batch_slice=slice(None)):
    """The reference's first three steps from ``weights`` →
    (StepSummary, {leaf: norm of its first raw gradient}).
    ``batch_slice`` keeps part of each batch (a fault's reading)."""
    b = config["train"]
    net = common.reference(config, weights, device, precision)
    sol = b["solver"]
    opt = RMSprop(net, sol["BASE_LR"], sol["WEIGHT_DECAY"], sol["ALPHA"], sol["EPS"])
    params0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    stats0 = stats_of(net)
    losses = []
    for i in range(FOLLOWED):
        batch = {k: v[batch_slice] for k, v in batches[i].items()}
        out = train_step(net, opt, batch, kwargs, config["model"]["VALID_THRESHOLD"]
                         if config["model"]["MASKED_LOSS"] else 0.0)
        losses.append(float(out["total_loss"]))
        if i == 0:
            raw = norms({n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in net.named_parameters()})
            grad = {n: float((v.double() / (1 - sol["ALPHA"])).sum().sqrt())
                    for n, v in opt.nu.items()}
            stats = changes(stats0, stats_of(net))
    summary = StepSummary(losses, grad,
                          changes(params0, {n: p.detach() for n, p in net.named_parameters()}),
                          stats)
    return summary, raw
