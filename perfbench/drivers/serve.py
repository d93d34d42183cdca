"""Serve: multi-view frames arrive at a fixed rate and the program's
``Predictor`` answers each, one at a time, in arrival order (an open loop:
a capture rig does not wait for its depth maps).

Traffic keys: ``pool`` scenes made from the seed, sent in turn;
``rate_per_s`` arrivals; ``warmup`` requests in set-up. A request is timed
from when it was due to when ``Predictor.__call__`` returned its numpy
maps, so a late start counts; every request due in the window is served,
up to a minute past its close. Every answer is kept and compared with the
reference's maps for its scene; a few of the distinct answers, drawn
from the seed, also iteration by iteration (``common.eval_numbers``). The
weights' BatchNorm statistics are calibrated (``common.seeded_weights``).
"""

from __future__ import annotations

import math
import time
import traceback
from typing import Dict

import numpy as np
import torch

from perfbench import inputs
from perfbench.check import KEPT
from perfbench.drivers import common
from perfbench.reference.model import request_inputs

LATE_S = 60.0


class _TimedModel:
    """Stands in for ``Predictor.model`` in a traced run: the model call
    as a harness span, synchronized at its end, its host time noted."""

    def __init__(self, model, tracer):
        self.model, self.tracer = model, tracer

    def __call__(self, *args, **kwargs):
        with self.tracer.span("model_call"):
            t0 = time.perf_counter()
            out = self.model(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.tracer.note("model_call_s", time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self.model, name)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from pointmvsnet_tpu_torch.predictor import Predictor

        self.cell, self.device = cell, device
        self.block = cell.config["eval"]
        tr, b = cell.traffic, self.block
        self.scenes = inputs.scene_pool(seed, tr["pool"], b["views"], b["height"], b["width"],
                                        b["num_depth"], tr.get("plane_fracs", (0.25, 0.70)))
        self.weights = common.seeded_weights(cell.config, seed, device, calibrate=True)
        self.pred = Predictor(common.program_cfg(cell.config, "eval"),
                              state_dict=self.weights, device=device)
        for i in range(tr["warmup"]):
            frames, cams, _ = self.scenes[i % len(self.scenes)]
            self.pred(frames, cams)
        self.pick = inputs.rng(seed, "check")
        self.answers = []                       # (scene, {map: array})

    def window(self, seconds: float, tracer) -> Dict:
        rate = self.cell.traffic["rate_per_s"]
        due_n = math.ceil(seconds * rate)
        if tracer.enabled:
            self.pred.model = _TimedModel(self.pred.model, tracer)
        lat, failed = [], 0
        t0 = time.perf_counter()
        for i in range(due_n):
            due = t0 + i / rate
            with tracer.item(i):
                with tracer.span("wait"):
                    time.sleep(max(0.0, due - time.perf_counter()))
                if time.perf_counter() > t0 + seconds + LATE_S:
                    failed += due_n - i                   # never answered
                    break
                j = i % len(self.scenes)
                frames, cams, _ = self.scenes[j]
                with tracer.span("request"):
                    start = time.perf_counter()
                    try:
                        out = self.pred(frames, cams)
                    except Exception:
                        traceback.print_exc()
                        failed += 1
                        continue
                    done = time.perf_counter()
                tracer.note("request_s", done - start)
            lat.append(done - due)
            self.answers.append((j, {k: out[k] for k in KEPT if k in out}))
        t_end = time.perf_counter()
        if isinstance(self.pred.model, _TimedModel):
            self.pred.model = self.pred.model.model
        ms = np.asarray(lat) * 1e3
        values = {"maps_per_s": len(lat) / (t_end - t0)}
        if len(ms):
            values["request_ms_p90"] = float(np.percentile(ms, 90))
            values["request_ms_p50"] = float(np.percentile(ms, 50))
        return {"values": values, "attempted": due_n, "failed": failed}

    def probe_inputs(self):
        """The model, scene 0's tensors and the forward's options, for the
        per-layer probes."""
        frames, cams, _ = self.scenes[0]
        images, cms = request_inputs(frames, cams)
        return (self.pred.model, images.to(self.device), cms.to(self.device),
                common.forward_kwargs(self.block))

    def free(self) -> None:
        del self.pred

    def check(self, memo: Dict) -> Dict[str, float]:
        ref = common.EvalReference(self.cell.config, self.weights, self.device)
        bits = common.MaskBits()

        def tensors(j):
            frames, cams, _ = self.scenes[j]
            return tuple(t.to(self.device) for t in request_inputs(frames, cams))
        nums = common.eval_numbers(ref, tensors, self.answers, self.pick, bits)
        memo["mask_bits"] = bits.mean()
        return nums
