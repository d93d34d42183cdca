"""Cascade: CasMVSNet (``MODEL.NAME casmvsnet``) called back to back on
inputs already on the card, one synchronize per map, as ``forward.py``
does for Point-MVSNet.

Traffic keys: ``pool`` scenes made from the seed at the configuration's
size, with its cameras' depth range (``depth_min``, ``depth_interval``,
``num_depth`` base planes), cropped to multiples of 32 and normalized,
put on the card in set-up and sent in turn; ``warmup`` maps in set-up;
``check_maps`` maps of the window kept for the comparison, a uniform
sample drawn from the seed (reservoir sampling).

The comparison (``check``): for each kept map, each stage's depth and
confidence against the f32 plain reference (``reference/casmvsnet.py``)
on the same weights and inputs, as mean |program − f32| over mean
|reference in the configuration's precision − f32| (``check._ratio``);
and, for up to ``common.FOLLOW`` distinct answers, ``stage<s>_step``:
the same ratio of stage s's depth, both references having started stage s
from the program's own ``stage<s>_input``. Weights are the reference's
names and shapes drawn from the seed (the program's U-Nets' final-conv
bias, which the published network has not, is zero), the eval BatchNorm
statistics calibrated on the f32 reference (``casmvsnet.calibrate_bn``)
over a calibration scene at half the size.

``probe``: the span readers' probe (``perfbench/spans.py``'s, with this
driver's map as the item): ``trace_items`` maps under the profiler after
the window, each device operation under the program spans open at its
launch.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
import traceback
from typing import Dict

import numpy as np
import torch

from perfbench import inputs, spans
from perfbench.check import _ratio, worst
from perfbench.drivers.common import FOLLOW
from perfbench.reference import casmvsnet as ref
from perfbench.reference.model import PRECISION_OF, request_inputs

STAGES = (1, 2, 3)
KEPT = tuple(f"stage{s}_{m}" for s in STAGES for m in ("depth", "confidence")) + tuple(
    f"stage{s}_input" for s in STAGES[1:])
BASE = 32          # the cascade's crop base


def program_cfg(config: Dict):
    """A configuration file → the program's config node."""
    from pointmvsnet_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    for key, value in config["model"].items():
        if isinstance(value, dict):
            for k, v in value.items():
                cfg.MODEL[key][k] = tuple(v) if isinstance(v, list) else v
        else:
            cfg.MODEL[key] = tuple(value) if isinstance(value, list) else value
    b = config["eval"]
    cfg.MODEL.DTYPE = b["dtype"]
    cfg.DATA.TEST.NUM_VIEW = b["views"]
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = b["num_depth"]
    cfg.DATA.TEST.IMG_HEIGHT, cfg.DATA.TEST.IMG_WIDTH = b["height"], b["width"]
    return cfg


def scenes(seed: int, block: Dict, count: int, fracs=(0.25, 0.70), stream: str = "scenes"):
    """``count`` scenes of the seed at the block's size and depth range →
    [(images (1, V, H, W, 3), cams (1, V, 2, 4, 4))] f32 on the host."""
    g = inputs.rng(seed, stream)
    out = []
    for _ in range(count):
        frames, cams, _ = inputs.render_scene(
            g, block["views"], block["height"], block["width"], block["num_depth"], fracs,
            depth_min=block["depth_min"], depth_interval=block["depth_interval"])
        out.append(request_inputs(frames, cams, base=BASE))
    return out


def seeded_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's weights from the seed, its BatchNorm statistics
    calibrated by the f32 reference on a scene of the seed at half the
    eval size (a multiple of 32)."""
    with torch.device("meta"):
        template = ref.build(config["model"]).state_dict()
    weights = inputs.weights(template, seed, device)
    b = config["eval"]
    half = dict(b, height=max(64, b["height"] // 2 // BASE * BASE),
                width=max(64, b["width"] // 2 // BASE * BASE))
    images, cams = scenes(seed, half, 1, stream="calibration")[0]
    net = reference(config, weights, device)
    ref.calibrate_bn(net, images.to(device), cams.to(device), b["num_depth"])
    calibrated = {k: v.detach().clone() for k, v in net.state_dict().items()}
    del net
    if torch.device(device).type == "cuda":     # the program's peak is the run's to report
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return calibrated


def reference(config: Dict, weights: Dict[str, torch.Tensor], device,
              precision: str = "f32") -> ref.CasMVSNet:
    net = ref.build(config["model"], precision).to(device)
    net.load_state_dict(weights)
    return net.eval()


def reference_maps(net, images, cams, num_depth: int, stage_inputs=None) -> Dict[str, np.ndarray]:
    with torch.no_grad():
        out = net(images, cams, num_depth, stage_inputs=stage_inputs)
    return {k: v[0].float().cpu().numpy() for k, v in out.items()}


def numbers(answers, tensors, config: Dict, weights, device, pick: np.random.Generator,
            precision: str = None) -> Dict[str, float]:
    """The comparison of ``answers`` [(scene, {key: map})]: every answer's
    maps, and ``FOLLOW`` of the distinct ones stage by stage; the largest
    of each number."""
    b = config["eval"]
    f32 = reference(config, weights, device)
    stated = reference(config, weights, device, precision or PRECISION_OF[b["dtype"]])
    nd = b["num_depth"]
    refs = {j: (reference_maps(f32, *tensors(j), nd), reference_maps(stated, *tensors(j), nd))
            for j in sorted({j for j, _ in answers})}
    nums = [{k: _ratio(ans[k], refs[j][0][k], refs[j][1][k])
             for k in KEPT if not k.endswith("_input")} for j, ans in answers]
    distinct = {}
    for j, ans in answers:
        key = (j, *(hashlib.sha1(np.ascontiguousarray(ans[f"stage{s}_input"])).hexdigest()
                    for s in STAGES[1:]))
        distinct.setdefault(key, (j, ans))
    chosen = list(distinct.values())
    if len(chosen) > FOLLOW:
        chosen = [chosen[i] for i in sorted(pick.choice(len(chosen), FOLLOW, replace=False))]
    for j, ans in chosen:
        starts = {s: torch.from_numpy(ans[f"stage{s}_input"])[None].to(device)
                  for s in STAGES[1:]}
        r32 = reference_maps(f32, *tensors(j), nd, starts)
        rlo = reference_maps(stated, *tensors(j), nd, starts)
        nums.append({f"stage{s}_step": _ratio(ans[f"stage{s}_depth"], r32[f"stage{s}_depth"],
                                              rlo[f"stage{s}_depth"]) for s in STAGES[1:]})
    return worst(nums)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from pointmvsnet_tpu_torch import disable_tf32
        from pointmvsnet_tpu_torch.models import build_model

        self.cell, self.device = cell, device
        self.block = b = cell.config["eval"]
        tr = cell.traffic
        self.model = build_model(program_cfg(cell.config), device)
        disable_tf32()
        self.weights = seeded_weights(cell.config, seed, device)
        self.model.load_state_dict(ref.program_weights(self.weights))
        self.tensors = [tuple(t.to(device) for t in s)
                        for s in scenes(seed, b, tr["pool"], tr.get("plane_fracs", (0.25, 0.70)))]
        self.pick = inputs.rng(seed, "check")
        for i in range(tr["warmup"]):
            self._map(i)
        self.kept = []                          # (map index, scene, {key: tensor})

    def _map(self, i: int):
        images, cams = self.tensors[i % len(self.tensors)]
        with torch.inference_mode():
            out = self.model(images, cams, num_virtual_plane=self.block["num_depth"])
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
                keep = {key: out[key] for key in KEPT}
                if len(self.kept) < k:
                    self.kept.append((n, n % len(self.tensors), keep))
                else:
                    slot = int(self.pick.integers(0, n + 1))
                    if slot < k:
                        self.kept[slot] = (n, n % len(self.tensors), keep)
            n += 1
        t_end = time.perf_counter()
        return {"values": {"maps_per_s": (n - failed) / (t_end - t0)},
                "attempted": n, "failed": failed}

    def free(self) -> None:
        self.kept = [(i, j, {k: v[0].float().cpu().numpy() for k, v in out.items()})
                     for i, j, out in self.kept]
        del self.model

    def check(self, memo: Dict) -> Dict[str, float]:
        return numbers([(j, out) for _, j, out in self.kept], lambda j: self.tensors[j],
                       self.cell.config, self.weights, self.device, self.pick)


def probe(run):
    """The span probe over this driver's maps, once per run
    (``run.memo["spans"]``, which ``spans.device_ms_per_item`` reads);
    None without a card. Its breakdown goes to standard error, with the
    share of the busy device time launched under a ``cascade.`` span."""
    def measure():
        d = run.driver
        if d.device.type != "cuda":
            return None
        rec = spans.profile_items(d._map, run.cell.traffic["trace_items"], "map", d.device)
        names = {n for *_, chain in rec.ops for n in chain if n.startswith("cascade.")}
        share = rec.device_seconds(*names) / rec.busy_s if rec.busy_s > 0 else 0.0
        print(f"perfbench: spans over {rec.items} maps: busy {rec.busy_s:.6f} s, "
              f"{100 * share:.3f}% under a cascade. span, "
              f"{100 * rec.attributed_share():.3f}% under a program span, "
              f"{rec.unlaunched} operations with no launch event", file=sys.stderr)
        print(f"perfbench: spans, device s by innermost span: {json.dumps(rec.by_innermost())}",
              file=sys.stderr)
        print(f"perfbench: spans, top operations: {json.dumps(rec.top_ops(12))}",
              file=sys.stderr)
        print(f"perfbench: spans, idle s by span: {json.dumps(rec.idle_by_span())}",
              file=sys.stderr)
        return rec

    return run.once("spans", measure)
