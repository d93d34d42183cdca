"""Forward: the program's model called back to back on inputs already on
the card, one synchronize per map (the export's loop once its loader has
delivered).

Traffic keys: ``pool`` scenes made from the seed, normalized
(``request_inputs``, as the export's loader does) and put on the card in
set-up, sent in turn; ``warmup`` maps in set-up; ``check_maps``
maps of the window kept for the comparison, a uniform sample drawn from
the seed (reservoir sampling, so the sample is of every map the window
completed, and the kept outputs stay few), compared as the ``serve``
driver's answers are, a few of them iteration by iteration.
"""

from __future__ import annotations

import time
import traceback
from typing import Dict

import torch

from perfbench import inputs
from perfbench.check import KEPT
from perfbench.drivers import common
from perfbench.reference.model import request_inputs


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from pointmvsnet_tpu_torch import disable_tf32
        from pointmvsnet_tpu_torch.models import build_model

        self.cell, self.device = cell, device
        self.block = b = cell.config["eval"]
        tr = cell.traffic
        self.scenes = inputs.scene_pool(seed, tr["pool"], b["views"], b["height"], b["width"],
                                        b["num_depth"], tr.get("plane_fracs", (0.25, 0.70)))
        self.tensors = [tuple(t.to(device) for t in request_inputs(f, c))
                        for f, c, _ in self.scenes]
        self.weights = common.seeded_weights(cell.config, seed, device, calibrate=True)
        self.kwargs = common.forward_kwargs(b)
        self.model = build_model(common.program_cfg(cell.config, "eval"), device)
        disable_tf32()
        self.model.load_state_dict(self.weights)
        self.pick = inputs.rng(seed, "check")
        for i in range(tr["warmup"]):
            self._map(i)
        self.kept = []                          # (map index, scene, {map: tensor})

    def _map(self, i: int):
        images, cams = self.tensors[i % len(self.tensors)]
        with torch.inference_mode():
            out = self.model(images, cams, **self.kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def window(self, seconds: float, tracer) -> Dict:
        k = self.cell.traffic["check_maps"]
        n = failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tracer.item(n), tracer.span("map"):
                try:
                    out = self._map(n)
                except Exception:
                    traceback.print_exc()
                    failed += 1
                    out = None
            if out is not None:
                keep = {key: out[key] for key in KEPT if key in out}
                if len(self.kept) < k:
                    self.kept.append((n, n % len(self.scenes), keep))
                else:
                    slot = int(self.pick.integers(0, n + 1))
                    if slot < k:
                        self.kept[slot] = (n, n % len(self.scenes), keep)
            n += 1
        t_end = time.perf_counter()
        return {"values": {"maps_per_s": (n - failed) / (t_end - t0)},
                "attempted": n, "failed": failed}

    def probe_inputs(self):
        images, cams = self.tensors[0]
        return self.model, images, cams, self.kwargs

    def free(self) -> None:
        self.kept = [(i, j, {k: v[0].float().cpu().numpy() for k, v in out.items()})
                     for i, j, out in self.kept]
        del self.model

    def check(self, memo: Dict) -> Dict[str, float]:
        ref = common.EvalReference(self.cell.config, self.weights, self.device)
        bits = common.MaskBits()
        nums = common.eval_numbers(ref, lambda j: self.tensors[j],
                                   [(j, out) for _, j, out in self.kept], self.pick, bits)
        memo["mask_bits"] = bits.mean()
        return nums
