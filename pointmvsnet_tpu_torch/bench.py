"""Benchmark: DTU paper-eval full-pipeline inference throughput on one
card. The port's counterpart of the JAX package's ``bench.py``.

    python -m pointmvsnet_tpu_torch.bench [--device cuda|cpu] [--details PATH]

Prints ONE JSON line first, with ``bench.py``'s keys and metric name:
  {"metric": ..., "value": N, "unit": "depth_maps/sec/chip",
   "vs_baseline": N, "baseline_source": ...}

Headline config, ``bench.py``'s: 640×512 input, 5 views, D=96 coarse
hypotheses, coarse + 3 PointFlow iterations at TEST scales (0.25, 0.5,
1.0) → full-resolution output, BatchNorm eval, bf16; the port's synthetic
scene (``make_inputs``) and weights from ``init_params`` at
``cfg.RNG_SEED``, as ``Predictor`` draws them. ``MODEL.FLOW_CHUNK_ROWS``
-1 is unbanded in the port (the JAX package's AUTO bands flow3 in 64 or
128 rows); under eval BatchNorm both give the same maps bit for bit.

``vs_baseline`` divides by ``BASELINE_MAPS_PER_SEC`` = 1/3: the
Point-MVSNet paper's ~3 s per reference view on a 1080Ti-class GPU (see
BASELINE.md), the JAX package's baseline too. It is a GPU figure, not a
TPU number.

With ``--details PATH``, or ``BENCH_DETAILS`` set in the environment,
the details sections of ``bench.py`` go to PATH (default
``outputs/bench_torch/BENCH_DETAILS.json`` under the working directory;
never ``BENCH_DETAILS.json`` itself, the JAX package's record), each
section flushed atomically as it ends: ``complete`` (false until the
end), ``headline_latency_s``, ``measured_at``, ``baseline_source``,
``stages_s`` (``utils/profiler.py::stage_latencies``), ``V3_D48_fullres``,
``V5_D96_batch2``, ``roofline`` (``benchmarks/roofline.py``, at the
card's peaks) and ``train_step`` (``measure_train_step``), plus
``device``: the card's name and power limit from ``nvidia-smi``.

Departure from ``bench.py``: a failure exits non-zero. One before the
line prints ``bench.py``'s error line (value 0.0, ``error``); a failed
details section is recorded as ``{"error": ...}`` and leaves
``complete`` false. ``bench.py`` exits 0 either way; here a failed
section must not look like a finished run.

``make_inputs``, ``build`` and ``measure`` are also the helpers that
``benchmarks/tt_sweep.py`` imports. ``build`` leaves out ``bench.py``'s
``BENCH_*`` environment A/Bs: they select TPU engines that
``build_model`` rejects. Everything runs on CUDA unless the caller passes
``device="cpu"``; progress notes go to stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from pointmvsnet_tpu_torch import disable_tf32, resolve_device
from pointmvsnet_tpu_torch.benchmarks.roofline import roofline_table
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
from pointmvsnet_tpu_torch.parallel.train_step import TrainState, make_train_step
from pointmvsnet_tpu_torch.utils.convert import init_params
from pointmvsnet_tpu_torch.utils.profiler import stage_latencies, train_stage_latencies
from pointmvsnet_tpu_torch.utils.solver import build_optimizer

METRIC = "dtu_eval_depth_maps_per_sec_per_chip_640x512_V5_D96_3flow"
UNIT = "depth_maps/sec/chip"
BASELINE_MAPS_PER_SEC = 1.0 / 3.0  # paper-derived (~3 s/view, 1080Ti class)
BASELINE_SOURCE = ("Point-MVSNet paper efficiency section: ~3 s/view full "
                   "pipeline on 1080Ti-class GPU (TBD-verify; mount empty). "
                   "BASELINE.json target: >=5x vs V100.")
DEFAULT_DETAILS = os.path.join("outputs", "bench_torch", "BENCH_DETAILS.json")


def make_inputs(b, v, h, w, d, with_gt=False, device="cuda"):
    """The geometrically consistent synthetic scene of
    ``dataset/synthetic.py::make_scene_batch`` (textured planes rendered
    per view, per-image standardized, DTU-like cams) on ``device`` →
    (images (B, V, H, W, 3), cams (B, V, 2, 4, 4)[, gt (B, H, W, 1)])."""
    dev = resolve_device(device)
    images, cams, gt = make_scene_batch(b, v, h, w, d)
    out = (torch.tensor(images, device=dev), torch.tensor(cams, device=dev))
    if with_gt:
        out += (torch.tensor(gt[..., None], device=dev),)
    return out


def build(norm="bn", dtype="bfloat16", chunk_rows=None, fetch=None, device="cuda"):
    """The default config with ``norm``, ``dtype``, ``chunk_rows``
    (MODEL.FLOW_CHUNK_ROWS; None keeps the default) and ``fetch``
    (MODEL.FLOW_FETCH; None keeps the default) → (cfg, model in eval mode
    on ``device``). A fetch engine the port does not implement raises
    (``models.check_model_knobs``)."""
    cfg = get_default_cfg()
    cfg.MODEL.NORM = norm
    cfg.MODEL.DTYPE = dtype
    if chunk_rows is not None:
        cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    if fetch is not None:
        cfg.MODEL.FLOW_FETCH = fetch
    return cfg, build_model(cfg, device)


def measure(model, images, cams, kwargs, iters=15):
    """Sustained maps/s: a warm-up window, then the better of two timed
    windows, each ``iters`` back-to-back forwards under
    ``torch.inference_mode()`` closed by ONE synchronize, which bounds them
    all. The JAX version feeds each call a zero taken from the previous
    output so that the TPU runs them in order behind one host sync; on the
    card the stream already runs them in order. Raises if a window's last
    depth map is not finite. → (B / dt, dt), dt in seconds per forward."""
    def window():
        with torch.inference_mode():
            t0 = time.perf_counter()
            for _ in range(iters):
                out = model(images, cams, **kwargs)
            if images.is_cuda:
                torch.cuda.synchronize(images.device)
            dt = (time.perf_counter() - t0) / iters
        flows = sorted(k for k in out if k.startswith("flow") and not k.endswith("_input"))
        last = out[flows[-1] if flows else "coarse_depth_map"]
        if not bool(torch.isfinite(last).all()):
            raise FloatingPointError("measure: the last depth map is not finite")
        return dt

    window()
    dt = min(window(), window())
    return images.shape[0] / dt, dt


def _progress(msg: str) -> None:
    """Timestamped progress note to stderr (the JSON line owns stdout)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def _weights(cfg, model) -> None:
    """Weights as ``Predictor`` draws them without a checkpoint."""
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(cfg.RNG_SEED)))


def headline(device="cuda", b=1, v=5, h=512, w=640, d=96):
    """The headline's model and inputs: ``build()`` (bf16, BN eval, the
    default FLOW_CHUNK_ROWS) with seeded weights, ``make_inputs(b, v, h,
    w, d)`` and the forward's kwargs at TEST scales → (cfg, model, images,
    cams, kwargs)."""
    cfg, model = build(device=device)
    _weights(cfg, model)
    images, cams = make_inputs(b, v, h, w, d, device=device)
    kwargs = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TEST.IMG_SCALES),
                  inter_scales=tuple(cfg.MODEL.TEST.INTER_SCALES), num_virtual_plane=d)
    return cfg, model, images, cams, kwargs


def measure_train_step(batch_size=1, iters=8, with_stages=False, *, v=3, h=512, w=640,
                       d=48, device="cuda"):
    """Sustained train-step time at the reference DTU train config (V=3,
    D=48, 640×512, scales 0.25 / 0.5): forward, loss, backward and RMSprop
    (``parallel/train_step.py::make_train_step``) after one warm-up step,
    ``iters`` steps closed by one synchronize; raises if the last loss is
    not finite. → dict for the details file, ``bench.py``'s keys, plus
    ``stages_s`` (``utils/profiler.py::train_stage_latencies``) with
    ``with_stages``.

    ``build(chunk_rows=0)``: bf16, BN, unbanded, as ``bench.py``. The JAX
    function also sets ``MODEL.REMAT``, which the port's ``build_model``
    rejects: remat recomputes activations in the backward, which changes
    memory, not values. Weights from ``init_params`` at ``cfg.RNG_SEED``
    (the JAX function draws ``PRNGKey(0)``)."""
    cfg, model = build(chunk_rows=0, device=device)
    _weights(cfg, model)
    dev = next(model.parameters()).device
    images, cams, gt = make_inputs(batch_size, v, h, w, d, with_gt=True, device=dev)
    batch = {"images": images, "cams": cams, "gt_depth": gt}
    kwargs = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
                  inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES), num_virtual_plane=d)
    loss_fn = build_loss_fn(cfg)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()),
                                              steps_per_epoch=100))
    step = make_train_step(loss_fn, kwargs)
    state, losses = step(state, batch)                  # warm-up
    float(losses["total_loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        state, losses = step(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    total = float(losses["total_loss"])
    if not math.isfinite(total):
        raise FloatingPointError(f"measure_train_step: total_loss {total}")
    out = {"batch_size": batch_size, "steps_per_sec": 1.0 / dt,
           "samples_per_sec": batch_size / dt, "step_latency_s": dt}
    if with_stages:
        out["stages_s"] = train_stage_latencies(state, loss_fn, batch, kwargs)
    return out


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu". The card is asked for by its UUID: ``nvidia-smi`` ignores
    ``CUDA_VISIBLE_DEVICES`` and lists every card in PCI order, so a
    position in its list can name another card than torch's index."""
    if device.type != "cuda":
        return "cpu"
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    if not uuid.startswith("GPU-"):
        uuid = f"GPU-{uuid}"
    try:
        out = subprocess.run(["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(device)}; nvidia-smi failed: {e}"
    if out.returncode:
        return f"{torch.cuda.get_device_name(device)}; nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip()


def _flush_details(details: dict, path: str) -> None:
    """Atomically replace the details file: a kill mid-write must not
    leave a truncated one."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(details, f, indent=1)
    os.replace(tmp, path)


class DetailsFailed(RuntimeError):
    """The headline line was printed, and a details section failed."""


def run(device="cuda", details=None, b=1, v=5, h=512, w=640, d=96, train_d=48, iters=15,
        batch2_iters=8, train_iters=8) -> dict:
    """Measure the headline (``measure``, ``iters`` forwards a window) and
    print its JSON line; then, where ``details`` names a file (None: the
    default path if ``BENCH_DETAILS`` is set, else no details), the details
    sections at the same sizes: V=3 / D=``train_d`` at full resolution,
    the batch of 2 (``batch2_iters``), the roofline and the train step
    (``train_iters``). → the line. Raises ``DetailsFailed`` after the line
    if a section failed (recorded in the file, ``complete`` false)."""
    dev = resolve_device(device)
    disable_tf32()
    _progress(f"device {dev}")
    cfg, model, images, cams, kwargs = headline(dev, b, v, h, w, d)
    _progress("headline measure start")
    maps_per_sec, latency = measure(model, images, cams, kwargs, iters=iters)
    _progress(f"headline done: {maps_per_sec:.3f} maps/s")
    line = {"metric": METRIC, "value": round(maps_per_sec, 4), "unit": UNIT,
            "vs_baseline": round(maps_per_sec / BASELINE_MAPS_PER_SEC, 3),
            "baseline_source": "paper ~3s/view (1080Ti class); see BASELINE.md"}
    print(json.dumps(line), flush=True)

    if details is None and os.environ.get("BENCH_DETAILS"):
        details = DEFAULT_DETAILS
    if details is None:
        return line
    failed = []
    try:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        rec = {"complete": False,
               "headline_latency_s": latency,
               "measured_at": {key: cfg.MODEL[key] for key in (
                   "FLOW_FETCH", "FLOW_MOMENTS", "COARSE_FETCH", "FLOW_CHUNK_ROWS",
                   "FLOW_SRC_DTYPE", "DTYPE", "NORM")},
               "baseline_source": BASELINE_SOURCE,
               "device": device_line(dev)}
        _flush_details(rec, details)

        def section(name, fn):
            """Run one details section; a failure is recorded, and the run
            goes on to the next."""
            _progress(f"{name} start")
            try:
                rec[name] = fn()
            except Exception as e:      # e.g. out of card memory: record, go on
                rec[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
                failed.append(name)
                _progress(f"{name} failed: {rec[name]['error']}")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            _flush_details(rec, details)

        section("stages_s", lambda: stage_latencies(
            model, images, cams, kwargs["img_scales"], kwargs["inter_scales"], d))

        def _v3d48():
            im3, cm3 = make_inputs(1, 3, h, w, train_d, device=dev)
            mps3, lat3 = measure(model, im3, cm3, dict(kwargs, num_virtual_plane=train_d),
                                 iters=iters)
            return {"maps_per_sec": mps3, "latency_s": lat3}
        section("V3_D48_fullres", _v3d48)

        def _batch2():
            imb, cmb = make_inputs(2, v, h, w, d, device=dev)
            mpsb, latb = measure(model, imb, cmb, kwargs, iters=batch2_iters)
            return {"maps_per_sec": mpsb, "latency_s_per_batch": latb}
        section("V5_D96_batch2", _batch2)
        section("roofline", lambda: roofline_table(
            h=h, w=w, v=v, d=d, g=2 * cfg.MODEL.FLOW_INTERVAL_M + 1,
            base_c=cfg.MODEL.IMG_BASE_CHANNELS, edge_channels=tuple(cfg.MODEL.EDGE_CHANNELS),
            flow_channels=tuple(cfg.MODEL.FLOW_CHANNELS), knn_window=cfg.MODEL.KNN_WINDOW,
            k=cfg.MODEL.KNN))
        del model, images, cams
        section("train_step", lambda: measure_train_step(
            iters=train_iters, with_stages=True, v=3, h=h, w=w, d=train_d, device=dev))
        rec["complete"] = not failed
        _flush_details(rec, details)
    except Exception as e:              # the file could not be written; the line is out
        raise DetailsFailed(f"details file {details}: {type(e).__name__}: {e}") from e
    if failed:
        raise DetailsFailed(f"details sections failed: {failed}")
    _progress(f"details done: {details}")
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="DTU paper-eval throughput of the port on one "
                                            "card: one JSON line, details on request")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--details", default=None,
                   help=f"write the details sections here (default with BENCH_DETAILS "
                        f"set: {DEFAULT_DETAILS})")
    args = p.parse_args(argv)
    try:
        run(args.device, args.details)
    except DetailsFailed as e:          # the line is out; the file has the record
        _progress(str(e)[:300])
        return 1
    except Exception as e:              # no line yet: bench.py's error line
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {e}"[:300]}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
