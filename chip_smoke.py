"""On-card smoke test of the PyTorch / CUDA port (pointmvsnet_tpu_torch).

    python3 chip_smoke.py          # one NVIDIA H100 (sm_90a), CUDA toolkit with nvcc

Phases, one or more lines each; any failure raises and exits non-zero:

1. env     torch / CUDA versions, card name and power limit (every card
           line of the script is ``bench.device_line``'s: nvidia-smi asked
           for the card by its UUID; on a one-card machine it must equal
           the one line nvidia-smi lists), and torch's
           TF32 flags as the process starts. The script does not set them:
           each entry point turns TF32 off itself, and the parity, train
           and export phases check that it did (flags off after
           ``Predictor``, ``train()`` and ``test.test``, each entered with
           TF32 allowed), so every f32 gate holds for what users get.
2. build   nvcc builds the six kernel sources in csrc/, in parallel: the
           tuned kNN and the general kNN, the masked max (one kernel for
           every shape), the probe's row gather, PointFlow's fused fetch,
           the plane sweep.
3. dataplane  the C++ host data plane (native/src/dataplane.cpp and
           image.cpp): g++'s version, flags and build time; the C path
           bit-equal to the Python readers on this host (its numpy may
           differ) on the reference train tree at 640×512 (cams, depth
           PFMs), on 3-channel and scaled PFMs and on 2000 seeded cam files
           under 3 interval scales and 5 counts; host times (mean) of
           load_pfm and load_cam on both paths beside the bytes' read, of
           load_pfm_batch (49 maps, 1 thread and all); the image path bit-equal
           to its Python versions and timed on both: JPEG decode at 1600×1200
           and 800×640, read_png of a 640×512 PNG with Up and with Paeth
           rows, the linear resize 1600×1200 → 640×480; the DTU train loader
           (configs/dtu_wde3.yaml) in items/s at NUM_WORKERS 1 and 4, C path
           and PMVS_NO_NATIVE=1, and on a copy of its tree with Paeth rows.
           The train and export phases check ``native.loads``: the C path
           read their PFMs, cams and PNGs.
4. kernels each CUDA kernel of the model against its plain PyTorch version
           on the card, at every shape the paper-eval forward gives it:
           windowed kNN (idx and mask bit-equal) and masked window max
           (bit-equal, bf16 and f32); the kernel's device time
           (torch.profiler), the plain version's time (CUDA events), and
           the bound of the same work (the masked max at G = 5, window 5
           stages 4x32 tiles of 64-byte chunks). Then inputs meant to break
           them:
           the kNN on integer-lattice points (exact d² ties), on
           duplicated hypothesis levels and on grids that are not a
           multiple of its tile; the masked max on NaN rows, on {−0, +0,
           ±1} (signed zeros, exact ties), under kNN masks and random ones
           (out-of-image bits, bits past G·25, empty masks), in bf16 and
           f32, at widths that take its vector and its scalar path; each
           against the plain version on the card and (on the small grids)
           on the CPU, NaN positions first, then the bits of the rest.
   point-fetch  PointFlow's fused fetch (csrc/point_fetch.cu) bit-equal to
           the composition it replaces on seeded inputs meant to break it
           (B=2, V-1 of 2 and 4, bf16 and f32 levels, every channel
           chunk), in the paper-eval and T&T forwards (each call, flow1-3,
           3 launches a map) and at FLOW_CHUNK_ROWS 64; its CUPTI time per
           call and per map beside the composition's and the bound.
   sweep   the plane sweep's cost volume (csrc/plane_sweep.cu) bit-equal to
           the composition it replaces, cast to the features' dtype, on
           seeded inputs meant to break it (B=2, V-1 of 2 and 4, bf16 and
           f32, C of 8, 16, 32 and every channel chunk, planes and
           per-pixel depths), in the paper-eval, T&T and CasMVSNet (bf16
           and f32) forwards (each call; coarse_*, flow1-3, stage1-3_*; 1,
           1 and 3 launches a map); its CUPTI time beside the composition's and the
           bound at the DTU and T&T coarse shapes and CasMVSNet's stages.
5. gather  the probe's windowed row gather (csrc/window_gather.cu) against
           its plain version, bit-equal, at the probe's default shape and
           at one whose rows fill the upper slab and the padded last
           window; kernel, plain, torch.index_select and bound times; then
           the probe's own entry point.
6. parity  the port at 64×128, V=3, D=16, f32, through Predictor: card
           (kernels) against the CPU (plain versions), same seeded
           weights; depth bars of tests/test_full_parity.py.
7. serve   Predictor at the paper-eval config (640×512, V=5, D=96, bf16,
           BatchNorm eval, 3 PointFlow iterations) answers 3 requests on a
           synthetic scene; each must launch exactly 3 kNN, 9 masked-max,
           3 fetch and 1 sweep kernels and return finite maps; one more
           request runs under the profiler (device busy share, top kernels).
8. train   train() at the reference training config (640×512, V=3, D=48,
           B=4, BatchNorm, f32, flows at 0.25 / 0.5) on a synthetic DTU
           tree written by the port: 2 coarse-only and 2 flow steps with
           validation, a checkpoint, and a resume to 6 steps; kernel
           launches per flow step and validation batch; every kernel call
           of one validation batch (B=4) bit-equal to its plain version on
           the same inputs; steady step time, peak memory and the
           device-busy share of one profiled step.
9. train-parity  EdgeConv's train-mode backward on a fixed kNN graph,
           card against CPU; then one train step at 64×128, V=3, D=16, B=2,
           f32, seeded weights and noisy images, coarse-only and with both
           flows, the kNN fed the same points on both sides: card against CPU,
           losses, every gradient and the BN running statistics, with the
           bars set out in phase_train_parity.
10. export  the eval pipeline: a DTU eval-release tree of 800×640 JPEGs
           (scan 1, 5 views, D=96) written by the port's JPEG writer; the
           test CLI (configs/dtu_wde3.yaml, bf16, TEST.WEIGHT = the train
           phase's last checkpoint) decodes, scales by 0.8 to 640×512 and
           exports 5 maps, each with exactly 3 kNN and 9 masked-max
           launches; one exported flow3 map against Predictor on the same
           item; the fuse CLI with the torch backend on the card, with
           numpy and with torch on the CPU, each pair held to the JAX
           package's bar between its backends (equal counts, 1e-3).
11. export-dtu  the test CLI at DTU's real image size: an eval-release tree
           of 1600×1200 JPEGs (scan 1, 6 views, D=96), the CLI at
           configs/dtu_wde3.yaml in bf16 with weights from RNG_SEED; the C
           data plane decodes and scales every view by 0.4 to 640×480, the
           base-64 crop gives 640×448 maps; 3 kNN and 9 masked-max launches
           per map, a finite flow3, ``native.loads`` of JPEGs and resizes
           above 0, one item bit-equal with and without PMVS_NO_NATIVE=1;
           host ms of the C and Python decode and resize, maps/s over the
           loop and after the first map.
12. weights  the weights the JAX package loads. A reference-layout .pth
           (tests/torch_mirror.py's TorchPointMVSNet at full width, BN
           statistics not an identity, a ``module.`` prefix) converted by
           the convert CLI in a subprocess and read by
           ``Predictor(weight_path=)``: one paper-eval request (bf16, 3 kNN
           and 9 masked-max launches) bit-equal to Predictor given the
           in-process conversion; then in f32 at the parity config the
           port from the converted weights against the mirror's own
           forward on the card (its kNN selection on the host), with
           tests/test_full_parity.py's bars. Then the orbax checkpoint the
           JAX package wrote (tests/data/orbax_tiny/), decoded by
           utils/orbax_reader.py on this host, the port on the card against
           the JAX package's depth beside it (expected.npz), the same bars.
           Conversion and read times, host clock.
13. trained  export and fusion from the checkpoint the JAX package trained
           (tests/data/orbax_trained/: full widths, BatchNorm, read by
           utils/orbax_reader.py) at the paper-eval config (640x512, V=5,
           D=96, 3 flows) on scan 1 of an eval-release tree of PNGs the port
           writes (its pixels' digest equal to the one the JAX package's
           outputs were computed on): the test CLI in f32 then bf16, 3 kNN
           (tuned) and 9 masked-max launches per map, no plain version on
           a CUDA tensor; the fuse CLI (torch on the card) against the
           scene's true cloud. Gates against the JAX package's outputs
           beside the checkpoint (expected.npz): f32 flow3 and prob of the
           stored view within tests/test_full_parity.py's bars, f32 fused
           n_points within 1% and accuracy / completeness / overall within
           2% relative; bf16 finite with overall within 10% of f32's.
           maps/s of each export and the fusion's seconds beside the card.
14. fusion-scan  both fusion backends on 49 noisy true depth maps of
           640×512 (a DTU eval scan's view count) at the fuse CLI's
           defaults: times, the card's peak memory, each cloud's accuracy
           / completeness against the scene; the card held to torch on the
           CPU on 9 of the maps (bars in phase_fusion_scan).
15. train-bf16  the train phase with MODEL.DTYPE bfloat16: step counter,
           checkpoints and resume, 0 skipped steps, finite parameters, 2
           kNN and 0 masked-max launches per flow step, 2 kNN and 6
           masked-max (bf16; 4 at F=32, 2 at F=64) per validation batch,
           the validation batch's kernel calls bit-equal to their plain
           versions, step time and peak memory beside the f32 phase's, a
           profiled step; then one B=2 BatchNorm bf16 flow step, finite.
16. learn  the port's learning run (pointmvsnet_tpu_torch/benchmarks/
           train_synthetic.py, the counterpart of the JAX package's
           functional check) at its defaults, 64×128, V=3 of a
           4-view tree, D=16, B=2, GN, RMSprop 1e-3, 30 steps per epoch
           asked (28 in the loader), 2 coarse-only + 2 flow epochs, in f32
           and then bf16: the script's rule (coarse loss down, <1_pct_cor
           up), 0 skipped steps, finite parameters, 2 tuned kNN launches
           per flow train step and per flow eval step, none in coarse steps
           and no masked max (GroupNorm takes EdgeConv's gather path in
           eval too, in both packages), no plain version on a CUDA tensor,
           the first flow eval step's kernel calls bit-equal to their plain
           versions, and the masked max bit-equal to its plain version
           on that step's EdgeConv z rows and kNN masks; first →
           last numbers, steady step times. Then the
           closed loop from the trained and the initial weights (both saved
           by the Checkpointer): the test CLI on scan 1 of an eval tree of
           the same size (4 maps, 3 tuned kNN launches and no masked max
           each, a finite flow3), the fuse CLI (torch, prob 0, 2 views) with
           --gt_dir holding the true depth maps back-projected; accuracy,
           completeness and overall finite, and overall lower from the
           trained weights.
17. train-dp  train() inside a one-rank NCCL group bit-equal to train()
           without a group (2 + 2 steps, deterministic algorithms, in a
           process of its own); then two ranks on cuda:0 over gloo at
           64×128, global B=4, BN, f32 and bf16, a coarse-only and a flow
           step each, against the one-rank step at B=4 on the card, with
           the bars of tests/test_torch_distributed.py (printed). One card
           cannot show NCCL between cards.
18. parallel-eval  the paper-eval request through Predictor at
           MODEL.FLOW_CHUNK_ROWS 0, 64 and 128 (row bands of the flow maps
           with an 8-row halo): kNN / masked-max launches per request
           (3 / 9, 14 / 42, 7 / 21), latency, peak memory and
           utils/profiler.py's stage_latencies; every kernel call of a
           banded request bit-equal to its plain version at its band grid
           and timed there (CUPTI), beside the plain version and the bound;
           the banded depth against the unbanded one (max and mean |Δ|
           within tests/test_full_parity.py's bars, and whether bit-equal).
           Then two gloo ranks on cuda:0 (spawned, a FileStore; NCCL
           refuses two ranks on one device): grid (1, 2, 1) at
           FLOW_CHUNK_ROWS 64, each rank's answer bit-equal to the serial
           banded request; grid (1, 1, 2) at V=4, within rtol / atol 1e-4
           of the serial request at V=4 (tests/test_parallel.py's bars).
           Then the test CLI on a (1, 2, 2) grid of four ranks at 64×128,
           V=4, D=16, f32, FLOW_CHUNK_ROWS 16: its PFMs within 1e-4 of the
           one-rank export.
19. envelope  the kernels over the Pallas kernels' whole envelope and
           banded PointFlow in training. The general kNN
           (csrc/window_knn_general.cu) bit-equal to its plain version at
           (G, k, win) in ENV_KNN and, forced, at the tuned (5, 16, 5), on
           a 37x53 grid (also against the CPU) and the flow1 grid, on
           random, lattice and duplicated-level points; the masked max
           (csrc/masked_window_max.cu) at each of those (G, win), F
           10/32/64/160, bf16 and f32, NaN rows and {-0, +0, ±1}, kNN and
           random masks, and at F = 2^21 + 8 bf16 (past 65535 blocks of
           channel chunks). Device time of the general kNN and the masked
           max at the paper-eval flow grids with k = 8, window 5 and 3,
           beside the plain versions and the bound, the tuned kNN's and the
           masked max's time per request at k = 16 beside the ones PERF.md
           records, and the general kNN forced on the tuned kNN's inputs
           (k = 16, window 5), bit-equal to it. Paper-eval requests at
           MODEL.KNN 8, windows 5 and 3: 3 general kNN launches, 9
           masked-max launches, no plain version on a CUDA tensor, latency.
           Card against CPU at 64x128 (Predictor depth with
           tests/test_full_parity.py's bars, one flow train step with
           phase_train_parity's) at KNN 8, KNN 8 with window 3, and
           FLOW_INTERVAL_M 3 with window 3 (G = 7); one train step with
           FLOW_CHUNK_ROWS 8 (1 + 4 bands). Then train() with
           FLOW_CHUNK_ROWS 64 at the reference train config: 2 + 4 bands,
           6 kNN launches per flow step, finite, step time and peak memory
           beside the unbanded step's. A whole run takes this phase right
           after train, while CUPTI still returns device times.
20. tanks  Tanks & Temples at its own frame sizes (run right after
           envelope). The port's tt_sweep (pointmvsnet_tpu_torch/benchmarks/
           tt_sweep.py, the counterpart of benchmarks/tt_sweep.py) on its
           four default tokens and unbanded 1280x1024 and 1920x1024 (T&T's
           1920x1080 frame after the base-64 crop), paper-eval model (V=5,
           D=96, bf16, BN eval), weights seed 0: maps/s, latency and peak
           memory per token, no error, launches per map by kernel (3 kNN,
           all tuned, and 9 masked max unbanded; a kNN per band and three
           masked max per band banded), no plain version on a CUDA tensor.
           Then the forward at 1280x1024 with FLOW_CHUNK_ROWS 0, 64, 32 and
           128 on the same inputs and weights, every banded map bit-equal to
           the unbanded one; at 1280x1024 and 1920x1024 unbanded every kernel
           call bit-equal to its plain version on its real inputs (NaN
           positions and the sign of zero included) and timed (CUPTI) beside
           the plain version and the bound. Then the test CLI
           (configs/tanks.yaml, bf16, weights from RNG_SEED, SHAPE_SET
           ((1024, 1920), (1024, 1280))) on a T&T tree of two scenes of 6
           JPEGs, Family 1920x1080 with 256 depths in its cams and Horse
           1280x1080: each scene's shape, 12 maps, every file, 3 kNN and 9
           masked-max launches per map, every flow3 bit-equal to Predictor's
           on the same item; maps/s over the loop and after each shape's
           first map, forward ms and peak memory per shape, the loader's ms
           per item (5 decodes, no cache) and the loop's wait for it. Then
           the fuse CLI on the export (torch on the card), each scene's
           seconds and peak memory, Horse on the numpy backend against the
           card within the JAX package's bar.
21. bench  (run right after serve) the port's counterpart of bench.py,
           ``python -m pointmvsnet_tpu_torch.bench`` in a process of its own
           with BENCH_DETAILS set and ``--details`` in a temp dir: exit code
           0, one stdout line with exactly bench.py's keys and metric name
           and a finite value above 0; the details file complete, with
           bench.py's sections (stages_s, V3_D48_fullres, V5_D96_batch2,
           roofline at the card's peaks, train_step with its stages) plus
           ``device``, and no error. Then one forward on the headline's
           inputs in this process: 3 kNN launches, all tuned, and 9
           masked-max launches, a finite flow3. Prints the headline, the sections' times
           and each roofline row's ceiling beside the measured stage that
           holds it.

Then the script's time from the build's start, a JSON line of
per-kernel numbers (``launches`` per serving request for the tuned kNN
and the masked max, per KNN 8 request for the general kNN, with the
masked max's time per KNN 8 request beside its own; per train step and
validation batch in f32 and in bf16; per learning flow step, eval step
and closed-loop map in each dtype; per exported map; per request from
converted weights; per map from the JAX package's trained checkpoint;
per banded request; per KNN 8 request and banded
train step; per T&T map and sweep token, with the time, plain time
and bound per T&T map at 1280x1024 and 1920x1024), the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. ``--phases
dataplane,point-fetch,sweep,train,train-bf16,learn,train-dp,export-dtu,weights,trained,parallel-eval,envelope,tanks,bench``
(any subset of the fourteen) runs only those, to try them on the card, and
prints no result lines. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
FLOWS = [(128, 160), (256, 320), (512, 640)]   # paper-eval flow grids
G, K, WIN = 5, 16, 5
EDGE_F = (32, 32, 64)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def allow_tf32() -> None:
    """TF32 allowed for convolutions and matmuls, as a process may find the
    flags before any entry point ran: the next entry point must turn both off."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def check_f32(what: str) -> None:
    flags = tf32_flags()
    check(flags == (False, False), f"{what} left TF32 flags {flags}, want both off")
    print(f"tf32: after {what}, entered with TF32 allowed: cudnn.allow_tf32={flags[0]} "
          f"matmul.allow_tf32={flags[1]}", flush=True)


def smi_line() -> str:
    """The current card's name and power limit, by ``bench.device_line``
    (``nvidia-smi`` asked for the card by its UUID)."""
    from pointmvsnet_tpu_torch.bench import device_line
    return device_line(torch.device("cuda", torch.cuda.current_device()))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of the CUDA kernel whose name contains ``kernel``
    over ``reps`` calls of ``fn``, from torch.profiler (CUPTI), so the
    wrapper's host time is not counted; CUDA events around each call if
    the profiler saw no such kernel. → (ms, "cupti" | "events")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key and e.count]
    total_us = sum(getattr(e, "device_time_total", 0) or 0 for e in hits)
    if total_us > 0:
        return total_us / sum(e.count for e in hits) / 1e3, "cupti"
    return time_ms(fn, reps), "events"


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality up to NaN payloads: NaN at the same places, then the
    same bits elsewhere (torch.equal is False wherever a NaN is, and
    takes −0 == +0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    it = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(it)[~nan], b.view(it)[~nan])


def flow_points(h: int, w: int, dev) -> torch.Tensor:
    """Hypothesis points of a flow grid as the model makes them: a
    two-plane depth map with noise, G = 5 hypotheses along each ray."""
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models.pointmvsnet import hypothesis_points
    _, cams, gt = make_scene_batch(1, 1, h, w, 96, seed=h)
    depth = torch.tensor(gt, device=dev) + torch.randn(
        1, h, w, generator=torch.Generator().manual_seed(w)).to(dev)
    step = torch.full((1,), 2.5 * 0.375, device=dev)
    pts, _ = hypothesis_points(depth, step, 2, torch.tensor(cams[:, 0], device=dev))
    return pts.contiguous()


def knn_bound(h: int, w: int, g: int = G, k: int = K, win: int = WIN):
    """(bytes, flops) of one windowed-kNN call: coords in, idx and mask
    out; 8 flops per (query, in-image candidate)."""
    p, r = g * h * w, win // 2
    nw = -(-(g * win * win) // 32)
    ny = sum(min(h - 1, y + r) - max(0, y - r) + 1 for y in range(h))
    nx = sum(min(w - 1, x + r) - max(0, x - r) + 1 for x in range(w))
    return p * 12 + p * k * 4 + p * nw * 4, 8 * g * g * ny * nx


def mwm_bound(z: torch.Tensor, mask: torch.Tensor):
    """(bytes, flops) of one masked-max call: z and the mask words in, out
    out; one max per (set bit, channel)."""
    pop = sum(((mask.long() >> s) & 1) for s in range(32)).sum().item()
    return 2 * z.numel() * z.element_size() + mask.numel() * 4, pop * z.shape[2]


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_kernels(dev):
    from pointmvsnet_tpu_torch.ops.edge import masked_window_max_cuda, masked_window_max_plain
    from pointmvsnet_tpu_torch.ops.knn import window_knn, window_knn_cuda

    tot = {"window_knn": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, by=set()),
           "masked_window_max": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, by=set())}
    for fi, (h, w) in enumerate(FLOWS, 1):
        grid = (G, h, w)
        pts = flow_points(h, w, dev)
        idx, mask = window_knn_cuda(pts, grid)
        torch.cuda.synchronize()
        pidx, pmask = window_knn(pts, grid, K, WIN, with_mask=True)
        check(torch.equal(idx, pidx) and torch.equal(mask, pmask),
              f"window_knn flow{fi}: kernel != plain")
        err = float((idx.long() - pidx.long()).abs().max())
        ms, how = device_ms(lambda: window_knn_cuda(pts, grid), "window_knn_kernel")
        pms = time_ms(lambda: window_knn(pts, grid, K, WIN, with_mask=True), reps=3, warmup=1)
        bb, by = bound_ms(*knn_bound(h, w))
        t = tot["window_knn"]
        t["ms"] += ms; t["plain_ms"] += pms; t["bound_ms"] += bb; t["by"].add(by)
        t["err"] = max(t["err"], err)
        print(f"kernels: window_knn flow{fi} grid {grid}: idx+mask bit-equal; "
              f"kernel {ms:.4f} ms ({how}), plain {pms:.3f} ms, bound {bb:.4f} ms ({by})",
              flush=True)

        gen = torch.Generator(device=dev).manual_seed(fi)
        for f in sorted(set(EDGE_F)):
            for dtype in (torch.bfloat16, torch.float32):
                z = torch.randn(1, G * h * w, f, device=dev, generator=gen).to(dtype)
                out = masked_window_max_cuda(z, mask, grid)
                torch.cuda.synchronize()
                ref = masked_window_max_plain(z, mask, grid)
                check(same_bits(out, ref),
                      f"masked_window_max flow{fi} F={f} {dtype}: kernel != plain")
                err = float((out.float() - ref.float()).abs().max())
                ms, how = device_ms(lambda: masked_window_max_cuda(z, mask, grid),
                                    "masked_window_max_kernel")
                pms = time_ms(lambda: masked_window_max_plain(z, mask, grid), reps=3, warmup=1)
                bb, by = bound_ms(*mwm_bound(z, mask))
                print(f"kernels: masked_window_max flow{fi} F={f} {str(dtype)[6:]}: "
                      f"bit-equal; kernel {ms:.4f} ms ({how}), plain {pms:.3f} ms, "
                      f"bound {bb:.4f} ms ({by})", flush=True)
                if dtype == torch.bfloat16:      # the main path's type
                    n = EDGE_F.count(f)
                    t = tot["masked_window_max"]
                    t["ms"] += n * ms; t["plain_ms"] += n * pms; t["bound_ms"] += n * bb
                    t["by"].add(by)
                t = tot["masked_window_max"]
                t["err"] = max(t["err"], err)
    return tot


def special_z(kind: str, b: int, p: int, f: int, seed: int) -> np.ndarray:
    """``nan``: normal values with whole NaN rows and scattered NaN
    entries; ``zeros``: {−0, +0, +1, −1} drawn 0.6 / 0.05 / 0.05 / 0.3, so
    that many maxima are −0, many +0, and most are exact ties."""
    rng = np.random.RandomState(seed)
    if kind == "nan":
        z = rng.randn(b, p, f).astype(np.float32)
        z[0, rng.choice(p, 5, replace=False)] = np.nan
        z[b - 1, rng.choice(p, 60), rng.randint(0, f, 60)] = np.nan
        return z
    return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (b, p, f),
                      p=[0.6, 0.05, 0.05, 0.3])


def random_mask(b: int, g: int, h: int, w: int, dev, seed: int, win: int = WIN) -> torch.Tensor:
    """Selection bitplanes no kNN makes: a quarter of all bits of the mask
    words set (out-of-image bits and bits past G·win² included), 10% of
    the points empty."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nw = -(-(g * win * win) // 32)
    shape = (b, nw, g, h, w)
    words = [torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, device=dev,
                           dtype=torch.int64) for _ in range(2)]
    keep = torch.rand((b, 1, g, h, w), generator=gen, device=dev) >= 0.1
    return ((words[0] & words[1]) * keep).to(torch.int32)


def point_cases(rng, b: int, g: int, h: int, w: int) -> dict:
    """Seeded kNN inputs meant to break a kernel: random points, an integer
    lattice (exact d² ties) and hypothesis levels all at one point."""
    p = g * h * w
    return {"random": rng.rand(b, p, 3) * 10,
            "lattice": rng.randint(0, 3, (b, p, 3)),
            "duplicates": np.broadcast_to(
                (rng.rand(b, 1, h, w, 3) * 10), (b, g, h, w, 3)).reshape(b, p, 3)}


def phase_adversarial(dev):
    """The kNN and the masked max on inputs meant to break them, kernel
    against the plain version on the card and on the CPU (see the module
    docstring)."""
    from pointmvsnet_tpu_torch.ops.edge import masked_window_max_cuda, masked_window_max_plain
    from pointmvsnet_tpu_torch.ops.knn import window_knn, window_knn_cuda

    n_knn = n_mwm = 0
    grids = [(5, 37, 53), (5, 36, 52), (3, 20, 30), (G,) + FLOWS[0]]
    for gi, (g, h, w) in enumerate(grids):
        grid, p, b = (g, h, w), g * h * w, 2
        for case, arr in point_cases(np.random.RandomState(gi), b, g, h, w).items():
            pts = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)
            idx, mask = window_knn_cuda(pts, grid)
            torch.cuda.synchronize()
            small = gi < 3          # the CPU's plain versions are slow at flow1
            ref = window_knn(pts, grid, K, WIN, with_mask=True)
            cpu = window_knn(pts.cpu(), grid, K, WIN, with_mask=True) if small else ref
            check(torch.equal(idx, ref[0]) and torch.equal(mask, ref[1])
                  and torch.equal(idx.cpu(), cpu[0].cpu()) and torch.equal(mask.cpu(), cpu[1].cpu()),
                  f"window_knn {case} grid {grid}: kernel != plain")
            n_knn += 1
            if case != "random":
                continue
            for mcase, m in (("knn", mask), ("random", random_mask(b, g, h, w, dev, gi))):
                for f in ((32, 64, 10, 40) if gi == 0 else (32, 64)):
                    for kind in ("nan", "zeros"):
                        z32 = torch.from_numpy(special_z(kind, b, p, f, gi * 100 + f)).to(dev)
                        for dtype in (torch.bfloat16, torch.float32):
                            z = z32.to(dtype)
                            out = masked_window_max_cuda(z, m, grid)
                            torch.cuda.synchronize()
                            ref = masked_window_max_plain(z, m, grid)
                            cpu = (masked_window_max_plain(z.cpu(), m.cpu(), grid) if small
                                   else ref.cpu())
                            check(same_bits(out, ref) and same_bits(out.cpu(), cpu),
                                  f"masked_window_max {kind} {mcase}-mask grid {grid} F={f} "
                                  f"{dtype}: kernel != plain")
                            if kind == "nan":
                                check(bool(torch.isnan(out).any()), "no NaN reached the output")
                            elif mcase == "knn":
                                zero = out[out == 0]
                                check(bool(torch.signbit(zero).any())
                                      and bool((~torch.signbit(zero)).any()),
                                      "the ±0 case produced only one zero")
                            n_mwm += 1
    print(f"adversarial: window_knn {n_knn} cases (random, integer lattice, duplicated "
          f"levels; grids {grids}) and masked_window_max {n_mwm} cases (NaN rows, "
          f"{{-0, +0, ±1}}; kNN and random masks; F 10/32/40/64; bf16, f32): kernel "
          f"bit-equal to the plain version on the card and on the CPU", flush=True)


def phase_gather(dev):
    """The probe's windowed row gather: kernel against plain version at the
    probe's default shape (table 328,833 × 128 f32, N = 327,680, SPAN =
    2048) and at a shape whose rows sit in the upper slab and in the padded
    last window; times against torch.index_select and the bound; then the
    probe's entry point."""
    from pointmvsnet_tpu_torch.benchmarks import pallas_gather_probe as probe
    from pointmvsnet_tpu_torch.ops import window_gather as wg

    n, width, span = 512 * 640, 128, 2048
    table_np, idx_np = probe.make_inputs(probe.TABLE_ROWS, n, width)
    table = torch.from_numpy(table_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    idx_l = idx.long()
    table_p, q, rel = wg.prepare(table, idx, span)
    out = wg.window_gather_cuda(table_p, q, rel, span)
    torch.cuda.synchronize()
    ref = wg.window_gather_plain(table_p, q, rel, span)
    check(torch.equal(out, ref), "window_gather: kernel != plain at the probe's shape")
    check(torch.equal(out, table.index_select(0, idx_l)), "window_gather: != table[idx]")
    err = float((out - ref).abs().max())

    rows = probe.TABLE_ROWS
    gen = np.random.RandomState(3)
    idx2 = torch.from_numpy(np.concatenate([
        np.arange(span - 1, span - 1 + 512),              # q 0: all but one row upper
        rows - 1 - gen.randint(0, 600, 512)]).astype(np.int32)).to(dev)
    t2, q2, rel2 = wg.prepare(table, idx2, span)
    check(int((rel2 >= span).sum()) >= 511, "window_gather edge case: no upper-slab rows")
    out2 = wg.window_gather_cuda(t2, q2, rel2, span)
    torch.cuda.synchronize()
    check(torch.equal(out2, wg.window_gather_plain(t2, q2, rel2, span))
          and torch.equal(out2, table.index_select(0, idx2.long())),
          "window_gather: kernel != plain on the upper slab / last window")

    ms, how = device_ms(lambda: wg.window_gather_cuda(table_p, q, rel, span),
                        "window_gather_kernel")
    pms = time_ms(lambda: wg.window_gather_plain(table_p, q, rel, span), reps=10)
    lms = time_ms(lambda: table.index_select(0, idx_l), reps=10)
    # the rows this run's indices need (each read once), the output, rel, q
    rows_needed = int(torch.unique(idx).numel())
    nbytes = (rows_needed + n) * width * 4 + n * 4 + q.numel() * 4
    bb, by = bound_ms(nbytes, 0)
    print(f"gather: window_gather N={n} W={width} SPAN={span} table {tuple(table.shape)}: "
          f"bit-equal (and on the upper-slab / last-window case); kernel {ms:.4f} ms "
          f"({how}), plain {pms:.3f} ms, index_select {lms:.4f} ms, bound {bb:.4f} ms "
          f"({by}, {nbytes / 1e6:.1f} MB: {rows_needed} distinct rows in, {n} out)",
          flush=True)
    g0 = wg.launches
    res = probe.run(n, width, span)
    check(all(r["exact"] for r in res.values()), f"probe entry point: {res}")
    return dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bb, by=by, err=err,
                probe_launches=wg.launches - g0)


PF_WIDTHS = [(8, 16, 32), (4, 8, 16), (2, 4, 8), (3, 6, 12)]   # 8, 4, 2, 1 channels a thread


def edge_uv_z(shape, h: int, w: int, gen) -> tuple:
    """Seeded uv (shape + (2,)) and z (shape) at an (h, w) grid meant to
    break a bilinear fetch: uv over the image and a 3-pixel margin at random
    fractions, and for a share of the points on the last column or row
    exactly (the taps i0 + 1 or j0 + 1 outside), at integers, at negative
    fractions in (−1, 0), far outside (1e9); z negative, +0 or −0 (behind
    or on the camera plane) for another share."""
    u = torch.rand(shape, generator=gen) * (w + 6) - 3
    y = torch.rand(shape, generator=gen) * (h + 6) - 3
    kind = torch.randint(0, 12, shape, generator=gen)
    u = torch.where(kind == 1, float(w - 1), u)
    y = torch.where(kind == 2, float(h - 1), y)
    u, y = torch.where(kind == 3, u.round(), u), torch.where(kind == 3, y.round(), y)
    u = torch.where(kind == 4, -torch.rand(shape, generator=gen), u)
    y = torch.where(kind == 5, -torch.rand(shape, generator=gen), y)
    u = torch.where(kind == 6, 1e9, u)
    z = torch.rand(shape, generator=gen) * 500 + 1
    z = torch.where(kind == 7, -z, z)
    z = torch.where(kind == 8, 0.0, z)
    z = torch.where(kind == 9, -0.0, z)
    return torch.stack([u, y], -1), z


def fetch_cases(b: int, v: int, widths, h: int, w: int, dtype, dev, seed: int) -> tuple:
    """Seeded ``point_fetch_cuda`` arguments at an (h, w) flow grid (G = 5,
    level l at (h, w) / 2^l) meant to break it: uv and z by ``edge_uv_z``
    at level 0's grid; hypothesis depths ≤ 0 for about half; features and
    reference samples of both signs."""
    gen = torch.Generator().manual_seed(seed)
    n = h * w
    levels = [torch.randn(b, v, h >> l, w >> l, c, generator=gen).to(dtype)
              for l, c in enumerate(widths)]
    uv, z = edge_uv_z((b, v - 1, G * n), h, w, gen)
    refs = [torch.randn(b, n, c, generator=gen) for c in widths]
    hyp = torch.randn(b, G, n, generator=gen)
    return ([f.to(dev) for f in levels], uv.to(dev), z.to(dev), [r.to(dev) for r in refs],
            hyp.to(dev))


def point_fetch_bound(levels, uv, z, refs, hyp):
    """(bytes, flops) of one fused fetch: uv, z, the hypothesis depths, the
    source views of every level and the reference samples in, each once,
    the variance out in the levels' dtype; per (point, channel) 10·(V−1) + 5
    operations (a source view's blend 7, its square and two sums; the
    reference's square, two sums, two products by 1/V, the mean's square
    and the difference, less the first view's two sums)."""
    b, g, n = hyp.shape
    s, ctot = levels[0].shape[1] - 1, sum(f.shape[4] for f in levels)
    out = b * g * n * ctot
    nbytes = (4 * (uv.numel() + z.numel() + hyp.numel() + sum(r.numel() for r in refs))
              + sum(f[:, 1:].numel() * f.element_size() for f in levels)
              + out * levels[0].element_size())
    return nbytes, out * (10 * s + 5)


class record_calls:
    """Inside the block, the calls of ``module.<name>`` (a kernel's
    wrapper, which the model looks up there) are recorded with their
    arguments and outputs."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        self.calls, self.fn = [], getattr(self.module, self.name)

        def call(*args):
            out = self.fn(*args)
            self.calls.append((args, out))
            return out
        setattr(self.module, self.name, call)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


@contextlib.contextmanager
def composition(module):
    """Inside the block ``module``'s kernel rule (``fetch_kernel_applies``)
    holds for nothing: the model takes that module's composition on the
    card."""
    rule = module.fetch_kernel_applies
    module.fetch_kernel_applies = lambda *t: False
    try:
        yield
    finally:
        module.fetch_kernel_applies = rule


def phase_point_fetch(dev) -> tuple:
    """PointFlow's fused fetch (csrc/point_fetch.cu) against the composition
    it replaces (``point_fetch_plain``) on the card, bit for bit (NaN
    positions, then every bit, the sign of zero included): on
    ``fetch_cases`` at B = 2, V − 1 of 2 and 4, bf16 and f32 levels, at
    channel widths that take 8, 4, 2 and 1 channels a thread, on a 40x56
    and a 37x53 grid; then the
    paper-eval forward (640x512, V=5, D=96, bf16, ``bench.headline``) and
    the Tanks & Temples one (1920x1024), each kernel call against the
    composition on its inputs and flow1-3 against the forward with the
    composition, with 3 launches a map; and the paper-eval forward at
    FLOW_CHUNK_ROWS 64 (bands with their y_offset), flow1-3 bit-equal to the
    composition's, a launch per band. Prints the kernel's CUPTI ms, the
    bound and the composition's ms (CUDA events) per call and per map at
    the paper-eval and T&T flow grids. → ({grid: (ms, plain_ms, bound_ms,
    source)} per map, the largest |kernel − composition| of every call)."""
    import gc

    from pointmvsnet_tpu_torch import bench
    from pointmvsnet_tpu_torch.ops import sampling
    from pointmvsnet_tpu_torch.ops.sampling import point_fetch_cuda, point_fetch_plain

    err = [0.0]

    def held(out, args, what):
        want = point_fetch_plain(*args)
        nan = torch.isnan(out) | torch.isnan(want)
        diff = (out.float() - want.float()).abs()[~nan]
        most = float(diff.max()) if diff.numel() else 0.0
        err[0] = max(err[0], most)
        if not same_bits(out, want):
            fail(f"point-fetch {what}: kernel != composition ({int((diff > 0).sum())} of "
                 f"{out.numel()} differ, most by {most})")

    met = 0
    for dtype in (torch.bfloat16, torch.float32):
        for s in (2, 4):
            for widths in PF_WIDTHS if s == 4 else PF_WIDTHS[:1]:
                for h, w in ((40, 56), (37, 53)):
                    args = fetch_cases(2, s + 1, widths, h, w, dtype, dev, seed=met)
                    out = point_fetch_cuda(*args)
                    torch.cuda.synchronize()
                    held(out, args, f"cases {str(dtype)[6:]}, V-1={s}, widths {widths}, "
                                    f"grid {h}x{w}")
                    met += 1
    print(f"point-fetch: {met} seeded cases bit-equal to the composition (B=2, V-1 2 and 4, "
          f"bf16 and f32 levels, widths {PF_WIDTHS}, last row / column, negative fractions, "
          f"far outside, z <= 0 and -0, hypothesis depths <= 0)", flush=True)

    per_map = {}
    for label, (h, w) in (("paper-eval", (512, 640)), ("tanks", (1024, 1920))):
        cfg, model, images, cams, kwargs = bench.headline("cuda", 1, 5, h, w, 96)
        with torch.inference_mode():
            with composition(sampling):
                want = model(images, cams, **kwargs)
            sampling.launches = 0
            with record_calls(sampling, "point_fetch_cuda") as calls:
                got = model(images, cams, **kwargs)
            torch.cuda.synchronize()
        n = sampling.launches
        check(n == 3 and len(calls) == 3, f"point-fetch {label}: {n} launches a map, want 3")
        for key in ("flow1", "flow2", "flow3"):
            check(same_bits(got[key], want[key]),
                  f"point-fetch {label}: {key} differs from the composition's")
        tot = [0.0, 0.0, 0.0]
        how = set()
        for i, (args, out) in enumerate(calls, 1):
            held(out, args, f"{label} flow{i}")
            ms, src = cupti_ms(lambda: point_fetch_cuda(*args), "point_fetch")
            pms = time_ms(lambda: point_fetch_plain(*args), reps=3, warmup=1)
            bb, by = bound_ms(*point_fetch_bound(*args))
            grid = tuple(args[4].shape[1:])
            print(f"point-fetch: {label} flow{i} (G, n) {grid}: bit-equal; kernel {ms:.4f} ms "
                  f"({src}), composition {pms:.3f} ms, bound {bb:.4f} ms ({by})", flush=True)
            tot = [t + x for t, x in zip(tot, (ms, pms, bb))]
            how.add(src)
        per_map[label] = (*tot, "+".join(sorted(how)))
        print(f"point-fetch: {label} {h}x{w}: 3 launches a map, flow1-3 bit-equal to the "
              f"composition's; per map kernel {tot[0]:.4f} ms, composition {tot[1]:.3f} ms, "
              f"bound {tot[2]:.4f} ms", flush=True)
        del model, images, cams, want, got, calls
        gc.collect()
        torch.cuda.empty_cache()

    cfg, model = bench.build(chunk_rows=64)
    bench._weights(cfg, model)
    images, cams = bench.make_inputs(1, 5, 512, 640, 96)
    kwargs = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TEST.IMG_SCALES),
                  inter_scales=tuple(cfg.MODEL.TEST.INTER_SCALES), num_virtual_plane=96)
    with torch.inference_mode():
        with composition(sampling):
            want = model(images, cams, **kwargs)
        sampling.launches = 0
        got = model(images, cams, **kwargs)
        torch.cuda.synchronize()
    bands = sum(n_bands(int(512 * s), 64) for s in kwargs["img_scales"])
    check(sampling.launches == bands,
          f"point-fetch FLOW_CHUNK_ROWS 64: {sampling.launches} launches, want {bands}")
    for key in ("flow1", "flow2", "flow3"):
        check(same_bits(got[key], want[key]),
              f"point-fetch FLOW_CHUNK_ROWS 64: {key} differs from the composition's")
    print(f"point-fetch: paper-eval at FLOW_CHUNK_ROWS 64: {bands} launches (one a band), "
          f"flow1-3 bit-equal to the composition's; {smi_line()}", flush=True)
    return per_map, err[0]


SWEEP_WIDTHS = (8, 16, 32, 12, 6, 3)   # bf16: 8 channels a thread, then 4, 2 and 1
CAS_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "casmvsnet_dtu.yaml")


def sweep_cases(b: int, v: int, c: int, h: int, w: int, d: int, dtype, dev, seed: int,
                per_pixel: bool) -> tuple:
    """Seeded ``plane_sweep_cuda`` arguments at an (h, w) grid with d
    hypotheses a pixel, meant to break it: uv and z as ``edge_uv_z`` makes
    them (last row and column, negative fractions, far outside, z <= 0 and
    -0), depths of both signs (about half mask the reference view), planes
    (b, d) or per pixel (b, d, h, w); features of both signs."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(b, v, h, w, c, generator=gen).to(dtype)
    uv, z = edge_uv_z((b, v - 1, d * h * w), h, w, gen)
    depths = torch.randn((b, d, h, w) if per_pixel else (b, d), generator=gen)
    return feats.to(dev), uv.to(dev), z.to(dev), depths.to(dev)


def sweep_bound(feats, uv, z, depths):
    """(bytes, flops) of one sweep: uv, z and the depths in, every view's
    features once, the volume out in the features' dtype; per (hypothesis,
    channel) 10·(V−1) + 5 operations, as ``point_fetch_bound`` counts them."""
    b, v, h, w, c = feats.shape
    out = b * depths.shape[1] * h * w * c
    nbytes = (4 * (uv.numel() + z.numel() + depths.numel())
              + (feats.numel() + out) * feats.element_size())
    return nbytes, out * (10 * (v - 1) + 5)


def cascade_forward(dev, dtype: str = "bfloat16"):
    """CasMVSNet at its DTU test setting (configs/casmvsnet_dtu.yaml: 864x1152,
    V=5, 48 / 32 / 8 hypotheses) in ``dtype`` with seeded weights on a
    synthetic scene → (model, images, cams, kwargs)."""
    from pointmvsnet_tpu_torch.config import load_cfg_from_file
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import init_params

    cfg = load_cfg_from_file(CAS_CFG)
    cfg.MODEL.DTYPE = dtype
    model = build_model(cfg, "cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(5)))
    model = model.to(dev).eval()
    h, w = CAS_SIZE
    images, cams, _ = make_scene_batch(1, 5, h, w, 192, depth_interval=2.65, seed=7)
    return model, torch.tensor(images, device=dev), torch.tensor(cams, device=dev), dict(
        num_virtual_plane=192)


def phase_sweep(dev) -> tuple:
    """The plane sweep's kernel (csrc/plane_sweep.cu) against the
    composition it replaces (``plane_sweep_plain``: the composition from the
    projection, cast to the features' dtype) on the card, bit for bit (NaN
    positions, then every bit): on ``sweep_cases`` at B = 2, V − 1 of 2 and
    4, bf16 and f32 features, C of 8, 16 and 32 (and 12, 6, 3: 4, 2 and 1
    channels a thread), planes and per-pixel depths, on a 40x56 and a 37x53
    grid; then the paper-eval forward (640x512, V=5, D=96, bf16), the
    Tanks & Temples one (1920x1024) and CasMVSNet's (864x1152, V=5, 48 / 32
    / 8; in bf16, and in f32 too), each kernel call against the composition
    on its inputs and ``coarse_*``, ``flow1-3`` and ``stage1-3_*`` against
    the forward with the sweep's composition, with 1, 1 and 3 launches a
    map. Prints the
    kernel's CUPTI ms, the bound and the composition's ms (CUDA events) at
    the DTU and T&T coarse shapes and CasMVSNet's three stages. → ({shape:
    (ms, plain_ms, bound_ms, source)}, launches a map by forward, the
    largest |kernel − composition|)."""
    import gc

    from pointmvsnet_tpu_torch import bench
    from pointmvsnet_tpu_torch.ops import cost_volume
    from pointmvsnet_tpu_torch.ops.cost_volume import plane_sweep_cuda, plane_sweep_plain

    err = [0.0]

    def held(out, args, what):
        want = plane_sweep_plain(*args)
        nan = torch.isnan(out) | torch.isnan(want)
        diff = (out.float() - want.float()).abs()[~nan]
        most = float(diff.max()) if diff.numel() else 0.0
        err[0] = max(err[0], most)
        if not same_bits(out, want):
            fail(f"sweep {what}: kernel != composition ({int((diff > 0).sum())} of "
                 f"{out.numel()} differ, most by {most})")

    met = 0
    for dtype in (torch.bfloat16, torch.float32):
        for s in (2, 4):
            for c in SWEEP_WIDTHS if s == 4 else SWEEP_WIDTHS[:3]:
                for per_pixel in (False, True):
                    for h, w in ((40, 56), (37, 53)):
                        args = sweep_cases(2, s + 1, c, h, w, 6, dtype, dev, met, per_pixel)
                        out = plane_sweep_cuda(*args)
                        torch.cuda.synchronize()
                        held(out, args, f"cases {str(dtype)[6:]}, V-1={s}, C={c}, "
                                        f"{'per-pixel' if per_pixel else 'planes'}, {h}x{w}")
                        met += 1
    print(f"sweep: {met} seeded cases bit-equal to the composition (B=2, V-1 2 and 4, bf16 "
          f"and f32, C {SWEEP_WIDTHS}, planes and per-pixel depths, last row / column, "
          f"negative fractions, far outside, z <= 0 and -0, depths <= 0)", flush=True)

    timed, launches = {}, {}
    forwards = [("paper-eval", ("coarse_depth_map", "coarse_prob_map", "flow1", "flow2",
                                "flow3"), ("dtu coarse",)),
                ("tanks", ("coarse_depth_map", "coarse_prob_map", "flow1", "flow2", "flow3"),
                 ("tt coarse",)),
                ("casmvsnet", tuple(f"stage{s}_{m}" for s in (1, 2, 3)
                                    for m in ("depth", "confidence")),
                 ("cas stage1", "cas stage2", "cas stage3")),
                ("casmvsnet f32", tuple(f"stage{s}_{m}" for s in (1, 2, 3)
                                        for m in ("depth", "confidence")),
                 ("cas stage1 f32", "cas stage2 f32", "cas stage3 f32"))]
    for label, keys, shapes in forwards:
        if label.startswith("casmvsnet"):
            model, images, cams, kwargs = cascade_forward(
                dev, "float32" if label.endswith("f32") else "bfloat16")
        else:
            h, w = (512, 640) if label == "paper-eval" else (1024, 1920)
            _, model, images, cams, kwargs = bench.headline("cuda", 1, 5, h, w, 96)
        with torch.inference_mode():
            with composition(cost_volume):
                want = model(images, cams, **kwargs)
            cost_volume.launches = 0
            with record_calls(cost_volume, "plane_sweep_cuda") as calls:
                got = model(images, cams, **kwargs)
            torch.cuda.synchronize()
        n = cost_volume.launches
        launches[label] = n
        check(n == len(shapes) and len(calls) == n,
              f"sweep {label}: {n} launches a map, want {len(shapes)}")
        for key in keys:
            check(same_bits(got[key], want[key]),
                  f"sweep {label}: {key} differs from the composition's")
        for shape, (args, out) in zip(shapes, calls):
            held(out, args, f"{label} {shape}")
            ms, src = cupti_ms(lambda: plane_sweep_cuda(*args), "plane_sweep")
            pms = time_ms(lambda: plane_sweep_plain(*args), reps=3, warmup=1)
            bb, by = bound_ms(*sweep_bound(*args))
            feats, depths = args[0], args[3]
            grid = f"{feats.shape[3]}x{feats.shape[2]} D {depths.shape[1]} C {feats.shape[4]}"
            timed[shape] = (ms, pms, bb, src)
            print(f"sweep: {shape} ({grid}, {'per-pixel' if depths.dim() == 4 else 'planes'}): "
                  f"bit-equal; kernel {ms:.4f} ms ({src}), composition {pms:.3f} ms, bound "
                  f"{bb:.4f} ms ({by})", flush=True)
        print(f"sweep: {label}: {n} launches a map, {', '.join(keys)} bit-equal to the "
              f"composition's; {smi_line()}", flush=True)
        del model, images, cams, want, got, calls
        gc.collect()
        torch.cuda.empty_cache()
    return timed, launches, err[0]


def with_model(cfg, overrides):
    """``cfg`` with MODEL.<key> = value for each of ``overrides``."""
    for key, value in (overrides or {}).items():
        cfg.MODEL[key] = value
    return cfg


def phase_parity(overrides=None, what: str = "parity"):
    """The port at 64x128, V=3, D=16, f32, MODEL.<key> as ``overrides``
    say, through Predictor: card (kernels) against the CPU (plain
    versions), same seeded weights, tests/test_full_parity.py's bars."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils.convert import init_params

    cfg = with_model(get_default_cfg(), overrides)
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = 16       # IMG_SCALES (0.25, 0.5, 1.0) by default
    images, cams, _ = make_scene_batch(1, 3, 64, 128, 16)
    sd = init_params(build_model(cfg, "cpu"), torch.Generator().manual_seed(0))
    allow_tf32()
    card = Predictor(cfg, sd, device="cuda", normalize=False)
    check_f32("Predictor(cfg) on cuda")
    outs = {"cuda": card(images[0], cams[0]),
            "cpu": Predictor(cfg, sd, device="cpu", normalize=False)(images[0], cams[0])}
    report = []
    for key in ("coarse_depth_map", "flow1", "flow2", "flow3"):
        d = np.abs(outs["cuda"][key] - outs["cpu"][key])
        report.append(f"{key} max {d.max():.3e} mean {d.mean():.3e}")
        check(d.max() < 0.05 and d.mean() < 0.005, f"{what} {key}: max {d.max()} mean {d.mean()}")
    c = float(np.abs(outs["cuda"]["coarse_prob_map"] - outs["cpu"]["coarse_prob_map"]).max())
    check(c < 0.02, f"{what} confidence: max {c}")
    tag = "".join(f" {k} {v}" for k, v in (overrides or {}).items())
    print(f"{what}: f32 card vs cpu at 64x128 V=3 D=16{tag}: {'; '.join(report)}; "
          f"confidence max {c:.3e}", flush=True)


CAS_SIZE = (864, 1152)        # CasMVSNet's DTU test size (configs/casmvsnet_dtu.yaml)


def phase_cascade(dev):
    """CasMVSNet on the card: (1) the plane sweep's planes path bit-equal to
    its per-pixel path given the planes broadcast over the pixels, at
    Point-MVSNet's paper-eval coarse grid (bf16, 32 channels, 96 planes) and
    at the cascade's stage-1 grid (48 planes); (2) the model through
    ``Predictor`` at 864x1152, V=5, against the plain f32 reference
    (``tests/casmvsnet_reference.py``) on the card, same weights (the
    reference's BN statistics calibrated on a half-size scene): in f32 every
    stage's depth within tests/test_full_parity.py's bars and the
    confidence's mean |Δ| under 1e-3; in bf16 each stage's mean |Δ| within
    3 times the bf16 reference's own."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import casmvsnet_reference as ref
    from pointmvsnet_tpu_torch import disable_tf32
    from pointmvsnet_tpu_torch.config import load_cfg_from_file
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.ops.cost_volume import plane_sweep_volume
    from pointmvsnet_tpu_torch.ops.geometry import depth_hypotheses
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils.convert import init_params

    h, w = CAS_SIZE
    g = torch.Generator(device=dev).manual_seed(11)
    for what, (fh, fw, d, c) in (("paper-eval coarse", (64, 80, 96, 32)),
                                 ("cascade stage 1", (h // 4, w // 4, 48, 32))):
        _, cams, _ = make_scene_batch(1, 5, fh, fw, d)
        cams = torch.from_numpy(cams).to(dev)
        feats = torch.randn(1, 5, fh, fw, c, device=dev, generator=g).to(torch.bfloat16)
        planes = depth_hypotheses(cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], d)
        with torch.inference_mode():
            a = plane_sweep_volume(feats, cams, planes)
            b = plane_sweep_volume(feats, cams, planes[:, :, None, None].expand(1, d, fh, fw)
                                   .contiguous())
        check(same_bits(a, b), f"cascade: {what}: the per-pixel sweep differs from the planes'")
        print(f"cascade: {what} {fh}x{fw} D={d} C={c} bf16: the planes sweep is bit-equal to "
              f"the per-pixel sweep of broadcast depths", flush=True)
        del a, b, feats

    planes = 192
    images, cams, _ = make_scene_batch(1, 5, h, w, planes, depth_interval=2.65, seed=7)
    small, small_cams, _ = make_scene_batch(1, 5, h // 64 * 32, w // 64 * 32, planes,
                                            depth_interval=2.65, seed=8)
    model_cfg = {"IMG_BASE_CHANNELS": 8, "VOL_BASE_CHANNELS": 8,
                 "CASCADE": {"NDEPTHS": [48, 32, 8], "DEPTH_INTERVAL_RATIOS": [4.0, 2.0, 1.0]}}
    # the reference in float32: TF32 off whatever the phases before left
    # (cuDNN allows TF32 when a process starts)
    disable_tf32()
    f32 = ref.build(model_cfg)
    f32.load_state_dict(init_params(f32, torch.Generator().manual_seed(5)))
    f32 = f32.to(dev)
    ref.calibrate_bn(f32, torch.from_numpy(small).to(dev), torch.from_numpy(small_cams).to(dev),
                     planes)
    with torch.no_grad():
        want = {k: v[0].cpu().numpy() for k, v in
                f32(torch.from_numpy(images).to(dev), torch.from_numpy(cams).to(dev),
                    planes).items()}
        low = ref.build(model_cfg, "bf16").to(dev)
        low.load_state_dict(f32.state_dict())
        low.eval()
        scale = {k: v[0].cpu().numpy() for k, v in
                 low(torch.from_numpy(images).to(dev), torch.from_numpy(cams).to(dev),
                     planes).items()}
    sd = ref.program_weights({k: v.cpu() for k, v in f32.state_dict().items()})
    del f32, low
    torch.cuda.empty_cache()
    report = []
    for dtype in ("float32", "bfloat16"):
        cfg = load_cfg_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              "configs", "casmvsnet_dtu.yaml"))
        cfg.MODEL.DTYPE = dtype
        allow_tf32()
        pred = Predictor(cfg, sd, device=dev.type, normalize=False)
        check_f32(f"Predictor(casmvsnet, {dtype}) on {dev.type}")
        got = pred(images[0], cams[0])
        check(got["depth"].shape == (h, w), f"cascade: depth {got['depth'].shape}")
        for s in (1, 2, 3):
            for m in ("depth", "confidence"):
                key = f"stage{s}_{m}"
                d = np.abs(got[key] - want[key])
                if dtype == "float32":
                    ok = (d.max() < 0.05 and d.mean() < 0.005) if m == "depth" \
                        else d.mean() < 1e-3
                    report.append(f"f32 {key} max {d.max():.3e} mean {d.mean():.3e}")
                else:
                    own = float(np.abs(scale[key] - want[key]).mean())
                    ok = d.mean() <= 3 * own
                    report.append(f"bf16 {key} mean {d.mean():.3e} (bf16 reference {own:.3e})")
                check(ok, f"cascade {dtype} {key}: max {d.max()} mean {d.mean()}")
        del pred
        torch.cuda.empty_cache()
    print(f"cascade: Predictor at {h}x{w} V=5 (48, 32, 8) against the f32 reference on the "
          f"card: {'; '.join(report)}; {smi_line()}", flush=True)


def phase_serve():
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.ops import cost_volume, edge, knn, sampling
    from pointmvsnet_tpu_torch.predictor import Predictor

    cfg = get_default_cfg()
    cfg.MODEL.DTYPE = "bfloat16"
    h, w = cfg.DATA.TEST.IMG_HEIGHT, cfg.DATA.TEST.IMG_WIDTH
    v, d = cfg.DATA.TEST.NUM_VIEW, cfg.DATA.TEST.NUM_VIRTUAL_PLANE
    images, cams, gt = make_scene_batch(1, v, h, w, d, seed=0)
    pred = Predictor(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn.launches = 0
    edge.launches = 0
    sampling.launches = 0
    latencies = []
    for r in range(3):
        k0, e0, f0, s0 = knn.launches, edge.launches, sampling.launches, cost_volume.launches
        t0 = time.perf_counter()
        out = pred(images[0], cams[0])           # returns numpy: synchronized
        latencies.append((time.perf_counter() - t0) * 1e3)
        nk, ne, nf = knn.launches - k0, edge.launches - e0, sampling.launches - f0
        ns = cost_volume.launches - s0
        check((nk, ne, nf, ns) == (3, 9, 3, 1),
              f"request {r}: {nk} kNN, {ne} masked-max, {nf} point-fetch and {ns} sweep "
              f"launches, want 3, 9, 3 and 1")
        check(out["depth"].shape == (h, w) and out["confidence"].shape == (h // 8, w // 8),
              f"request {r}: shapes {out['depth'].shape} {out['confidence'].shape}")
        check(all(np.isfinite(a).all() for a in out.values()), f"request {r}: non-finite")
        print(f"serve: request {r}: {latencies[-1]:.1f} ms, launches knn {nk} "
              f"masked_window_max {ne} point_fetch {nf} plane_sweep {ns}, depth "
              f"[{out['depth'].min():.2f}, "
              f"{out['depth'].max():.2f}] (true {gt.min():.1f}/{gt.max():.1f})", flush=True)
    print(f"serve: 640x512 V={v} D={d} bf16, 3 flows: latency ms {latencies}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    profile_call(lambda: pred(images[0], cams[0]), "request")
    return nk, ne, nf, ns             # one request's launches (checked equal for all)


def _train_step_once(dev, kw, batch, sd, knn_hook=None, overrides=None):
    """One train step of the default-width model (f32, unmasked loss,
    MODEL.<key> as ``overrides`` say) from the state_dict ``sd`` on
    ``dev``; ``knn_hook`` wraps the model's kNN. → (losses, grads, BN
    statistics), on the CPU."""
    import pointmvsnet_tpu_torch.models.pointmvsnet as pmodel
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step, put_batch
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    cfg = with_model(get_default_cfg(), overrides)
    cfg.MODEL.NUM_VIRTUAL_PLANE = kw["num_virtual_plane"]
    cfg.MODEL.MASKED_LOSS = False
    model = build_model(cfg, dev)
    model.load_state_dict(sd)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    orig = pmodel.window_knn_idx
    pmodel.window_knn_idx = knn_hook(orig) if knn_hook else orig
    try:
        state, losses = make_train_step(build_loss_fn(cfg), kw)(state, put_batch(batch, dev))
    finally:
        pmodel.window_knn_idx = orig
    check(state.optimizer.count == 1, f"train step on {dev} skipped its update")
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
             for n, p in model.named_parameters()}
    stats = {n: b.cpu() for n, b in model.named_buffers() if "running" in n}
    return {k: float(v) for k, v in losses.items()}, grads, stats


def phase_edge_conv_backward():
    """Train-mode EdgeConv (the checkpointed gather path) on a fixed kNN
    graph, card against CPU, at the CPU test's two cases and at the
    default widths' first and last EdgeConv: gradients of the kernel, the
    BN scale and bias and the input within 1e-4 of their max |g|, outputs
    atol 1e-4, running statistics atol 1e-5 (the bars of
    tests/test_torch_train.py::test_edge_conv_train_gradients)."""
    from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
    from pointmvsnet_tpu_torch.ops.knn import window_knn

    report = []
    for seed, c, f in [(4, 6, 8), (5, 16, 32), (6, 56, 32), (7, 32, 64)]:
        rng = np.random.RandomState(seed)
        g, h, w = 5, 6, 8
        idx = window_knn(torch.from_numpy(rng.rand(2, g * h * w, 3).astype(np.float32)),
                         (g, h, w), K)
        x = torch.from_numpy(rng.randn(2, g * h * w, c).astype(np.float32))
        cot = torch.from_numpy(rng.randn(2, g * h * w, f).astype(np.float32))
        torch.manual_seed(seed)
        ref = EdgeConv(c, f, "bn")
        res = {}
        for dev in ("cpu", "cuda"):
            m = EdgeConv(c, f, "bn").to(dev)
            m.load_state_dict(ref.state_dict())
            m.train()
            xd = x.to(dev, copy=True).requires_grad_()
            out = m(xd, idx.to(dev))
            (out * cot.to(dev)).sum().backward()
            res[dev] = dict(out=out.detach().cpu(), x=xd.grad.cpu(),
                            **{n: p.grad.cpu() for n, p in m.named_parameters()},
                            **{n: b.cpu() for n, b in m.named_buffers() if "running" in n})
        cpu, card = res["cpu"], res["cuda"]
        worst = 0.0
        for k, v in cpu.items():
            d = float((card[k] - v).abs().max())
            if k == "out":
                check(d <= 1e-4, f"edge-conv backward C={c} F={f}: output max |Δ| {d:.3e}")
            elif "running" in k:
                check(d <= 1e-5, f"edge-conv backward C={c} F={f}: {k} max |Δ| {d:.3e}")
            else:
                rel = d / float(v.abs().max())
                check(rel <= 1e-4, f"edge-conv backward C={c} F={f}: grad {k} {rel:.3e} of max |g|")
                worst = max(worst, rel)
        report.append(f"C={c} F={f} {worst:.1e}")
    print(f"train-parity: EdgeConv train-mode backward, fixed kNN graph, card vs cpu: "
          f"gradients within 1e-4 of their max |g| (largest: {'; '.join(report)})", flush=True)


def phase_train_parity(overrides=None, n_knn: int = 2, what: str = "train-parity"):
    """One train step of the default-width model (MODEL.<key> as
    ``overrides`` say), card against CPU, coarse-only (without
    ``overrides``) and with both flows, whose ``n_knn`` kNN calls the CPU
    step records. The card's kNN kernel gets the CPU
    step's kNN input points (on the synthetic lattice a kNN near-tie flips
    under the two devices' ~1e-4 depth differences; the kernel is
    bit-equal to the plain version given the same points). Images with
    seeded noise (σ = 3) as in tests/test_torch_train_step.py; losses rtol
    1e-4, BN statistics atol 1e-5, each gradient within 1e-4 of its max |g|
    in the coarse-only step. With the flows on, f32 differences flip
    near-tied maxima of EdgeConv's max over K, and each flip sends a
    gradient to another neighbour: on the CPU alone, images × (1 + 1e-6)
    move this config's gradients by up to 13% of their max |g|. There the
    bar is 0.5 of max |g|, which a zeroed or sign-flipped gradient fails;
    EdgeConv's backward itself is held at 1e-4 by
    ``phase_edge_conv_backward``."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import init_params

    images, cams, gt = make_scene_batch(2, 3, 64, 128, 16, seed=5)
    images = (images + 3.0 * np.random.RandomState(7).randn(*images.shape)).astype(np.float32)
    batch = {"images": images, "cams": cams, "gt_depth": gt[..., None]}
    cfg = with_model(get_default_cfg(), overrides)
    sd = init_params(build_model(cfg, "cpu"), torch.Generator().manual_seed(0))
    n_head = len(cfg.MODEL.FLOW_CHANNELS)
    shift_invariant = ("vol_conv.convs.7.conv.bias",
                       f"point_flow.head.layers.{n_head - 1}.linear.bias")
    for is_flow in ((True,) if overrides else (False, True)):
        kw = dict(is_flow=is_flow, img_scales=(0.25, 0.5), inter_scales=(0.75, 0.375),
                  num_virtual_plane=16)
        points = []

        def record(orig):
            def knn(pts, *args):
                points.append(pts.clone())
                return orig(pts, *args)
            return knn

        def replay(orig):
            return lambda pts, *args: orig(points.pop(0).to(pts.device), *args)

        cpu = _train_step_once("cpu", kw, batch, sd, record, overrides)
        check(len(points) == (n_knn if is_flow else 0), f"{len(points)} kNN calls on the CPU")
        card = _train_step_once("cuda", kw, batch, sd, replay, overrides)
        check(not points, "the card step did not run its kNN")
        for k, v in cpu[0].items():
            check(np.isfinite(card[0][k]) and abs(card[0][k] - v) <= 1e-4 * abs(v),
                  f"{what} loss {k}: card {card[0][k]} cpu {v}")
        largest = max(float(g.abs().max()) for g in cpu[1].values())
        rel = 0.5 if is_flow else 1e-4
        gaps = []
        for name, g in cpu[1].items():
            tg = card[1][name]
            if name in shift_invariant:
                check(max(float(g.abs().max()), float(tg.abs().max())) < 1e-5 * largest,
                      f"{what} {name}: not ~0")
                continue
            # parameters no output uses have zero gradients on both sides
            gap = float((tg - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            check(gap <= rel, f"{what} grad {name}: max |Δg| {gap:.3e} of max |g|")
            gaps.append((gap, name))
        gaps.sort(reverse=True)
        sdiff = max(float((card[2][n] - v).abs().max()) for n, v in cpu[2].items())
        check(sdiff <= 1e-5, f"{what} BN statistics: max |Δ| {sdiff:.3e}")
        tag = "".join(f" {k} {v}" for k, v in (overrides or {}).items())
        print(f"{what}: {'flows on' if is_flow else 'coarse-only'} step at 64x128 "
              f"V=3 D=16 B=2 f32{tag}, {n_knn if is_flow else 0} kNN calls, card vs cpu: losses "
              f"{ {k: round(v, 6) for k, v in card[0].items() if k.endswith('loss')} }; "
              f"{len(cpu[1])} gradients within {rel:g} of their max |g| (largest "
              f"{', '.join(f'{n} {v:.2e}' for v, n in gaps[:3])}; "
              f"{sum(v > 1e-4 for v, _ in gaps)} above 1e-4); "
              f"BN statistics max |Δ| {sdiff:.2e}", flush=True)


def phase_train(dev, keep_ckpt: str, dtype: str = "float32") -> dict:
    """train() at the reference training config on a synthetic DTU tree
    written by the port, then a resume; launches, step time, memory and a
    profiled step; every kernel call of one validation batch held to its
    plain version on the same inputs. The last checkpoint is copied to
    ``keep_ckpt`` (if given) before the tree goes. → {kernel: launches per
    flow step / per val batch, "step_ms", "peak_gib", "losses"}."""
    from pointmvsnet_tpu_torch import native
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.build import build_data_loader
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
    from pointmvsnet_tpu_torch.models import build_loss_fn, pointmvsnet_metrics
    from pointmvsnet_tpu_torch.ops import edge, knn
    from pointmvsnet_tpu_torch.parallel import make_eval_step, make_train_step, put_batch
    from pointmvsnet_tpu_torch.train import train

    name = "train" if dtype == "float32" else "train-bf16"
    label = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg = get_default_cfg()
        cfg.MODEL.DTYPE = dtype
        h, w, d = 512, 640, cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE
        t0 = time.perf_counter()
        make_synthetic_dtu(os.path.join(work, "dtu"), scans=[2, 3, 5], num_views=3,
                           height=h, width=w, num_depth=d)
        print(f"{name}: synthetic DTU tree {w}x{h}, scans 2 (train) 3 5 (val), 3 views, "
              f"7 lights, in {time.perf_counter() - t0:.1f} s", flush=True)
        for split in ("TRAIN", "VAL"):
            cfg.DATA[split].ROOT_DIR = os.path.join(work, "dtu")
        cfg.SCHEDULER.INIT_EPOCH = 1
        cfg.SCHEDULER.MAX_EPOCH = 2
        out = os.path.join(work, "out")
        b = cfg.TRAIN.BATCH_SIZE
        n_flow = len(cfg.MODEL.TRAIN.IMG_SCALES)
        n_edge = len(cfg.MODEL.EDGE_CHANNELS)
        # epoch 0 coarse-only; epoch 1: 2 flow steps + 1 flow val batch
        want = (2 * n_flow + n_flow, n_edge * n_flow)
        for max_epoch, steps in ((2, 4), (3, 6)):
            cfg.SCHEDULER.MAX_EPOCH = max_epoch
            if max_epoch == 2:
                allow_tf32()
            knn.launches = edge.launches = 0
            native.loads.update(dict.fromkeys(native.loads, 0))
            t0 = time.perf_counter()
            state = train(cfg, out, max_steps_per_epoch=2, device="cuda")
            torch.cuda.synchronize()
            if max_epoch == 2:
                check_f32(f"train() ({label})")
            got = (knn.launches, edge.launches)
            read = dict(native.loads)
            check(read["pfm"] > 0 and read["cam"] > 0 and read["png"] > 0,
                  f"{name}: the C data plane read {read} (PFMs, cams, PNGs), want all > 0")
            check(state.step == steps, f"{name}: step counter {state.step}, want {steps}")
            check(state.optimizer.skipped_steps == 0, f"{name}: skipped a non-finite step")
            check(got == want, f"{name}: launches kNN/masked-max {got}, want {want}")
            ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
            check(f"{max_epoch - 1}.pt" in ckpts, f"{name}: checkpoints {ckpts}")
            check(all(torch.isfinite(p).all() for p in state.model.parameters()),
                  f"{name}: non-finite parameters")
            print(f"{name}: MAX_EPOCH={max_epoch} B={b} {label}: step counter {state.step}, "
                  f"checkpoints {ckpts}, skipped steps 0, launches kNN {got[0]} masked-max "
                  f"{got[1]}, C data plane read {read['pfm']} PFMs, {read['cam']} cams and "
                  f"{read['png']} PNGs, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

        kw = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
                  inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES),
                  num_virtual_plane=cfg.MODEL.NUM_VIRTUAL_PLANE)
        loss_fn = build_loss_fn(cfg)
        step = make_train_step(loss_fn, kw)
        batch = put_batch(next(iter(build_data_loader(cfg, "train"))), torch.device("cuda"))
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            k0, e0 = knn.launches, edge.launches
            t0 = time.perf_counter()
            state, losses = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = (knn.launches - k0, edge.launches - e0)
            check(got == (n_flow, 0), f"{name} step launches kNN/masked-max {got}")
            check(all(np.isfinite(float(v)) for v in losses.values()), f"losses {losses}")
        check(state.optimizer.skipped_steps == 0, f"{name}: skipped a non-finite step")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        k0, e0 = knn.launches, edge.launches
        with record_kernel_calls() as calls:
            _, vlosses, _ = make_eval_step(loss_fn, pointmvsnet_metrics, kw)(state, batch)
        torch.cuda.synchronize()
        vgot = (knn.launches - k0, edge.launches - e0)
        check(vgot == (n_flow, n_edge * n_flow), f"{name}: val batch launches {vgot}")
        check(all(np.isfinite(float(v)) for v in vlosses.values()), f"val losses {vlosses}")
        shapes = check_kernel_calls(calls, f"{name} val batch")
        print(f"{name}: flow step {w}x{h} V=3 D={d} B={b} {label}: step ms "
              f"{[round(t, 1) for t in times]}, max_memory_allocated {peak:.2f} GiB, launches "
              f"per step kNN {n_flow} masked-max 0, per val batch kNN {vgot[0]} masked-max "
              f"{vgot[1]}; the val batch's kernel calls bit-equal to their plain versions "
              f"({shapes}); losses "
              f"{ {k: round(float(v), 4) for k, v in losses.items() if k.endswith('loss')} }; "
              f"{smi_line()}", flush=True)
        profile_call(lambda: step(state, batch), f"train step (B={b}, {label})")
        if keep_ckpt:
            shutil.copy(os.path.join(out, "checkpoints", f"{cfg.SCHEDULER.MAX_EPOCH - 1}.pt"),
                        keep_ckpt)
        return {"window_knn": (n_flow, vgot[0]), "masked_window_max": (0, vgot[1]),
                "step_ms": times, "peak_gib": peak, "batch": {k: v[:2] for k, v in batch.items()},
                "kw": kw}
    finally:
        shutil.rmtree(work, ignore_errors=True)


class record_kernel_calls:
    """Inside the block, the model's calls of the kNN (with mask) and of the
    masked window max are recorded with their inputs and outputs."""

    def __enter__(self):
        import pointmvsnet_tpu_torch.models.edge_conv as medge
        import pointmvsnet_tpu_torch.models.pointmvsnet as mflow
        self.calls = []
        self.saved = [(mflow, "window_knn_mask", mflow.window_knn_mask),
                      (mflow, "window_knn_idx", mflow.window_knn_idx),
                      (medge, "masked_window_max", medge.masked_window_max)]
        for mod, attr, fn in self.saved:
            setattr(mod, attr, self._wrap(attr, fn))
        return self.calls

    def _wrap(self, attr, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((attr, args, kwargs, out))
            return out
        return call

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def check_kernel_calls(calls, what: str) -> str:
    """Each recorded kernel call against its plain version on the same
    inputs (no launch), bit for bit. → the shapes met, for the log."""
    from pointmvsnet_tpu_torch.ops.edge import masked_window_max_plain
    from pointmvsnet_tpu_torch.ops.knn import window_knn

    check(calls, f"{what}: no kernel call recorded")
    met = set()
    with torch.inference_mode():
        for attr, args, _, out in calls:
            if attr == "window_knn_mask":
                ref = window_knn(*args, with_mask=True)
                check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                      f"{what}: window_knn at {tuple(args[0].shape)} grid {args[1]}: "
                      f"kernel != plain")
                met.add(f"knn {tuple(args[0].shape)}")
            elif attr == "window_knn_idx":
                check(torch.equal(out, window_knn(*args)),
                      f"{what}: window_knn at {tuple(args[0].shape)} grid {args[1]}: "
                      f"kernel != plain")
                met.add(f"knn {tuple(args[0].shape)}")
            else:
                z = args[0]
                check(same_bits(out, masked_window_max_plain(*args)),
                      f"{what}: masked_window_max at {tuple(z.shape)} {z.dtype}: "
                      f"kernel != plain")
                met.add(f"mwm {tuple(z.shape)} {str(z.dtype)[6:]}")
    return ", ".join(sorted(met))


def phase_train_bf16(dev, f32: dict) -> dict:
    """``phase_train`` with MODEL.DTYPE bfloat16 (the JAX package's
    training precision; parameters and optimizer state stay f32), its step
    time and peak memory beside the f32 phase's of this run; then one flow
    step at B=2 with BatchNorm in bf16 from fresh seeded weights, which
    must be finite (the JAX package's TPU compile gives NaN there,
    docs/STATUS.md; on the card a NaN would be the port's fault)."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    res = phase_train(dev, None, dtype="bfloat16")
    med = {k: float(np.median(r["step_ms"])) for k, r in (("f32", f32), ("bf16", res))}
    print(f"train-bf16: flow step 640x512 V=3 D=48 B=4, median of 3 steady steps: bf16 "
          f"{med['bf16']:.1f} ms, f32 {med['f32']:.1f} ms ({med['bf16'] / med['f32']:.3f}x); "
          f"max_memory_allocated bf16 {res['peak_gib']:.2f} GiB, f32 {f32['peak_gib']:.2f} GiB; "
          f"{smi_line()}", flush=True)

    cfg = get_default_cfg()
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.MASKED_LOSS = False     # every flow pixel: a gradient through EdgeConv's BN
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.RNG_SEED)
        model = build_model(cfg, dev)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    state, losses = make_train_step(build_loss_fn(cfg), res["kw"])(state, res["batch"])
    finite = all(np.isfinite(float(v)) for v in losses.values())
    grads_finite = all(torch.isfinite(p.grad).all() for p in model.parameters()
                       if p.grad is not None)
    edge = max(float(p.grad.abs().max()) for n, p in model.named_parameters()
               if n.startswith("point_flow.edge_convs.") and "norm" in n)
    check(finite and grads_finite and state.optimizer.count == 1 and edge > 0
          and all(torch.isfinite(p).all() for p in model.parameters()),
          f"train-bf16: B=2 BatchNorm bf16 step not finite: {losses}, EdgeConv BN |g| {edge}")
    print(f"train-bf16: one flow step at B=2, BatchNorm, bf16, fresh weights, every flow pixel "
          f"in the loss: finite losses "
          f"{ {k: round(float(v), 4) for k, v in losses.items() if k.endswith('loss')} }, "
          f"finite gradients (EdgeConv BN max |g| {edge:.3e}), update applied", flush=True)
    return res


# ------------------------------------------------------------ learn

LEARN_H, LEARN_W, LEARN_STEPS = 64, 128, 30     # the learning script's defaults
LEARN_DTYPES = (("f32", "float32"), ("bf16", "bfloat16"))
# per flow train step / flow eval step / exported map: (kNN, masked max), the
# kNN all tuned. No masked max: the run is GroupNorm's, and EdgeConv takes its gather
# path under GN in eval too, in both packages (the max commutes only with BN's
# fixed affine or no norm); learn_dtype holds the masked max to its plain
# version on the trained EdgeConv inputs instead
LEARN_LAUNCHES = {"train": (2, 0), "eval": (2, 0), "map": (3, 0)}


def launch_delta(before: dict, after: dict) -> dict:
    return {n: after[n] - before[n] for n in after}


def tuned_only(delta: dict, want: tuple) -> bool:
    """``delta`` (launch_counts difference) is ``want`` (kNN, masked max)
    launches, every kNN the tuned kernel's."""
    return delta == {"window_knn": want[0], "window_knn_general": 0, "masked_window_max": want[1]}


class observe_learning_steps:
    """Inside the block, every train and eval step of the learning run
    (``pointmvsnet_tpu_torch/benchmarks/train_synthetic.py``) is
    synchronized and logged: kind, phase, launches by kernel (``launch_counts``),
    host ms. The kernel calls of the first flow eval step are recorded
    (``record_kernel_calls``), and so are its EdgeConv calls' inputs
    (module, x, keywords)."""

    def __enter__(self):
        from pointmvsnet_tpu_torch.benchmarks import train_synthetic
        self.mod = train_synthetic
        self.saved = (train_synthetic.make_train_step, train_synthetic.make_eval_step)
        self.log, self.calls, self.edge_inputs = [], None, []
        make_train, make_eval = self.saved
        train_synthetic.make_train_step = lambda loss_fn, kw: self._wrap(
            "train", kw["is_flow"], make_train(loss_fn, kw))
        train_synthetic.make_eval_step = lambda loss_fn, metric_fn, kw: self._wrap(
            "eval", kw["is_flow"], make_eval(loss_fn, metric_fn, kw))
        return self

    def _wrap(self, kind, is_flow, fn):
        def call(state, batch):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            if kind == "eval" and is_flow and self.calls is None:
                with record_kernel_calls() as self.calls, self._edge_inputs():
                    out = fn(state, batch)
            else:
                out = fn(state, batch)
            torch.cuda.synchronize()
            self.log.append(dict(kind=kind, flow=is_flow, ms=(time.perf_counter() - t0) * 1e3,
                                 launches=launch_delta(before, launch_counts())))
            return out
        return call

    @contextlib.contextmanager
    def _edge_inputs(self):
        from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
        forward = EdgeConv.forward

        def record(ec, x, knn_idx, **kw):
            self.edge_inputs.append((ec, x, kw))
            return forward(ec, x, knn_idx, **kw)
        EdgeConv.forward = record
        try:
            yield
        finally:
            EdgeConv.forward = forward

    def __exit__(self, *exc):
        self.mod.make_train_step, self.mod.make_eval_step = self.saved


def check_masked_max_on(edge_inputs, what: str) -> str:
    """The masked max (the CUDA kernel) against its plain version on the
    z rows and kNN masks of recorded EdgeConv calls, bit for bit: the max
    that EdgeConv's fast path takes under BN or no norm. → the shapes met."""
    from pointmvsnet_tpu_torch.ops.edge import masked_window_max, masked_window_max_plain

    check(edge_inputs, f"{what}: no EdgeConv call recorded")
    met = set()
    with torch.inference_mode():
        for ec, x, kw in edge_inputs:
            c = x.shape[-1]
            z = (x.to(ec.dtype) @ ec.kernel.to(ec.dtype)[c:]).contiguous()
            args = (z, kw["mask"], kw["grid_shape"], kw["window"])
            check(same_bits(masked_window_max(*args), masked_window_max_plain(*args)),
                  f"{what}: masked_window_max at {tuple(z.shape)} {z.dtype}: kernel != plain")
            met.add(f"mwm {tuple(z.shape)} {str(z.dtype)[6:]}")
    return ", ".join(sorted(met))


def closed_loop(label: str, dtype: str, weights: dict, work: str, dev) -> dict:
    """The test CLI on scan 1 of an eval-layout tree at the learning run's
    size from each of ``weights`` (name → checkpoint), then the fuse CLI
    (torch backend, prob 0, 2 views) against the scene's true points. →
    {name: fused cloud's metrics}, and the launches per map."""
    from pointmvsnet_tpu_torch import fuse
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.benchmarks import train_synthetic as ts
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu, true_cloud
    from pointmvsnet_tpu_torch.postprocess import write_ply

    scene = dict(scans=[1], num_views=ts.NUM_VIEWS, height=LEARN_H, width=LEARN_W,
                 num_depth=ts.NUM_DEPTH, depth_min=ts.DEPTH_MIN,
                 depth_interval=ts.DEPTH_INTERVAL)
    tree, gt_tree, gt_dir = (os.path.join(work, d) for d in ("eval", "gt_tree", "gt"))
    make_synthetic_dtu(tree, layout="eval", **scene)
    make_synthetic_dtu(gt_tree, **scene)
    gt = true_cloud(gt_tree, ts.NUM_VIEWS)
    os.makedirs(gt_dir, exist_ok=True)
    write_ply(os.path.join(gt_dir, "scan1.ply"), gt)
    out = {}
    for name, weight in weights.items():
        reset_launches()
        t0 = time.perf_counter()
        summary, depth_dir = test_cli.main([
            "--device", dev.type, "MODEL.DTYPE", dtype, "MODEL.NORM", "gn",
            "DATA.TEST.ROOT_DIR", tree, "DATA.TEST.NUM_VIEW", str(ts.NUM_VIEWS),
            "DATA.TEST.NUM_VIRTUAL_PLANE", str(ts.NUM_DEPTH), "DATA.TEST.IMG_HEIGHT",
            str(LEARN_H), "DATA.TEST.IMG_WIDTH", str(LEARN_W), "DATA.TEST.INTERVAL_SCALE",
            "1.0", "OUTPUT_DIR", os.path.join(work, f"export_{name}"), "TEST.WEIGHT", weight])
        t_cli = time.perf_counter() - t0
        n = summary["maps"]
        per_map = {k: c // max(n, 1) for k, c in launch_counts().items()}
        check(n == ts.NUM_VIEWS and tuned_only(launch_counts(), tuple(
            n * c for c in LEARN_LAUNCHES["map"])),
              f"learn {label} closed loop ({name}): {n} maps, launches {launch_counts()}, "
              f"want {ts.NUM_VIEWS} maps and {LEARN_LAUNCHES['map']} per map, kNN tuned")
        flow3 = io.load_pfm(os.path.join(depth_dir, "scan1", "00000000_flow3.pfm"))
        check(flow3.shape == (LEARN_H, LEARN_W) and np.isfinite(flow3).all(),
              f"learn {label} closed loop ({name}): flow3 {flow3.shape} not finite")
        r = fuse.main(["--depth_dir", depth_dir, "--out", os.path.join(work, f"clouds_{name}"),
                       "--backend", "torch", "--device", dev.type, "--prob_threshold", "0",
                       "--min_views", "2", "--gt_dir", gt_dir])["scan1"]
        m = {k: r[k] for k in ("accuracy", "completeness", "overall", "n_points")}
        check(r["backend"] == "torch" and all(np.isfinite(m[k]) for k in m),
              f"learn {label} closed loop ({name}): backend {r['backend']}, metrics {m}")
        out[name] = dict(m, test_cli_s=t_cli)
    print(f"learn {label}: closed loop at {LEARN_W}x{LEARN_H}, V={ts.NUM_VIEWS}, "
          f"D={ts.NUM_DEPTH}, scan 1 ({len(gt)} true points from {ts.NUM_VIEWS} true depth "
          f"maps): test CLI ({n} maps, launches per map {per_map}) then fuse CLI (torch, prob "
          f"0, 2 views, --gt_dir): "
          + "; ".join(f"{name} weights: accuracy {m['accuracy']:.4f} completeness "
                      f"{m['completeness']:.4f} overall {m['overall']:.4f} mm, "
                      f"{m['n_points']} points, test CLI {m['test_cli_s']:.1f} s"
                      for name, m in out.items())
          + f"; {smi_line()}", flush=True)
    check(out["trained"]["overall"] < out["initial"]["overall"],
          f"learn {label}: overall from the trained weights {out['trained']['overall']} is "
          f"not below the initial weights' {out['initial']['overall']}")
    return dict(metrics=out, per_map=per_map)


def learn_dtype(label: str, dtype: str, work: str, dev) -> dict:
    """The learning run (``train_synthetic.run`` at the script's defaults)
    in ``dtype`` with its gates, then its closed loop."""
    from pointmvsnet_tpu_torch.benchmarks import train_synthetic as ts
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.parallel import TrainState
    from pointmvsnet_tpu_torch.utils.checkpoint import Checkpointer
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    root = os.path.join(work, "train")
    ts.make_tree(root, LEARN_H, LEARN_W)
    cfg = get_default_cfg()
    cfg.MODEL.DTYPE = dtype
    # the run's initial weights, drawn as run() draws them, kept for the loop
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.RNG_SEED)
        model = build_model(ts.configure(cfg, root), dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    Checkpointer(os.path.join(work, "initial")).save(
        TrainState(model, build_optimizer(cfg, dict(model.named_parameters()))), 0)

    reset_launches()
    t0 = time.perf_counter()
    with observe_learning_steps() as obs, forbid_plain_on_cuda():
        res = ts.run(cfg, root, LEARN_STEPS, dev, init_state=init,
                     log=lambda s: print(f"learn {label}: {s}", flush=True))
    t_run = time.perf_counter() - t0
    state = res.state
    (c_first, c_last), (f_first, f_last) = res.coarse, res.flow
    n_steps = {p: len(s) for p, s in res.snapshots.items()}
    check(ts.learning_ok(c_first, c_last),
          f"learn {label}: not learning: coarse loss {c_first['total_loss']} -> "
          f"{c_last['total_loss']}, <1_pct_cor {c_first['<1_pct_cor']} -> {c_last['<1_pct_cor']}")
    check(state.optimizer.skipped_steps == 0
          and all(s["skipped_steps"] == 0 for p in res.snapshots.values() for s in p),
          f"learn {label}: {state.optimizer.skipped_steps} skipped steps")
    check(all(torch.isfinite(p).all() for p in state.model.parameters()),
          f"learn {label}: non-finite parameters")
    check(state.step == sum(n_steps.values()) == len(obs.log) // 2,
          f"learn {label}: step counter {state.step}, snapshots {n_steps}, "
          f"{len(obs.log)} steps observed")
    for kind in ("train", "eval"):
        for flow, want in ((False, (0, 0)), (True, LEARN_LAUNCHES[kind])):
            bad = [e["launches"] for e in obs.log if e["kind"] == kind and e["flow"] == flow
                   and not tuned_only(e["launches"], want)]
            check(not bad, f"learn {label}: {kind} steps ({'flow' if flow else 'coarse'}) "
                           f"launched {bad[:2]}, want {want}, kNN tuned")
    check(obs.calls is not None, f"learn {label}: no flow eval step recorded")
    shapes = check_kernel_calls(obs.calls, f"learn {label} flow eval step")
    reset_launches()
    mwm_shapes = check_masked_max_on(obs.edge_inputs, f"learn {label} flow eval step")
    check(launch_counts()["masked_window_max"] == len(obs.edge_inputs),
          f"learn {label}: the masked max on the EdgeConv inputs ran {launch_counts()}")
    ms = {(k, f): [e["ms"] for e in obs.log if e["kind"] == k and e["flow"] == f]
          for k in ("train", "eval") for f in (False, True)}
    # steady: the phase's second epoch (the first holds cuDNN's and the allocator's warm-up)
    steady = {key: float(np.median(v[len(v) // 2:])) for key, v in ms.items()}
    print(f"learn {label}: {LEARN_W}x{LEARN_H}, V=3 of {ts.NUM_VIEWS}, D={ts.NUM_DEPTH}, B=2, "
          f"GN, RMSprop lr 1e-3, {dtype}: {n_steps['coarse']} coarse + {n_steps['flow']} flow "
          f"steps ({LEARN_STEPS} per epoch asked, {n_steps['coarse'] // 2} in the loader) in "
          f"{t_run:.1f} s; coarse loss {c_first['total_loss']:.4f} -> {c_last['total_loss']:.4f}, "
          f"<1_pct_cor {c_first['<1_pct_cor']:.4f} -> {c_last['<1_pct_cor']:.4f}; flow loss "
          f"{f_first['total_loss']:.4f} -> {f_last['total_loss']:.4f}, <1_pct_cor "
          f"{f_first['<1_pct_cor']:.4f} -> {f_last['<1_pct_cor']:.4f}, <1_pct_flow1 "
          f"{f_first.get('<1_pct_flow1', 0):.4f} -> {f_last.get('<1_pct_flow1', 0):.4f}, "
          f"<1_pct_flow2 {f_first.get('<1_pct_flow2', 0):.4f} -> "
          f"{f_last.get('<1_pct_flow2', 0):.4f}; lr coarse {c_first['lr']:g} -> "
          f"{c_last['lr']:g}, flow {f_first['lr']:g} -> {f_last['lr']:g}; skipped steps 0, "
          f"parameters finite; launches per flow train step kNN/masked-max "
          f"{LEARN_LAUNCHES['train']}, per flow eval step {LEARN_LAUNCHES['eval']}, kNN tuned, "
          f"0 in coarse steps (GN: EdgeConv's gather path); one flow eval step's kernel calls "
          f"bit-equal to their plain versions ({shapes}), and the masked max on its "
          f"{len(obs.edge_inputs)} EdgeConv calls' z rows and kNN masks ({mwm_shapes}); "
          f"steady ms (median of each phase's second epoch, synchronized) train coarse "
          f"{steady[('train', False)]:.2f} flow {steady[('train', True)]:.2f}, eval coarse "
          f"{steady[('eval', False)]:.2f} flow {steady[('eval', True)]:.2f}; "
          f"{smi_line()}", flush=True)
    for line in ts.summary_lines(c_first, c_last, f_first, f_last):
        print(f"learn {label}: {line.strip()}", flush=True)

    trained = os.path.join(work, "trained")
    Checkpointer(trained).save(state, 3)
    loop = closed_loop(label, dtype, {"trained": os.path.join(trained, "3.pt"),
                                      "initial": os.path.join(work, "initial", "0.pt")},
                       work, dev)
    flow_launches = {k: next(e["launches"] for e in obs.log if e["kind"] == k and e["flow"])
                     for k in ("train", "eval")}
    return dict(coarse=res.coarse, flow=res.flow, loop=loop, launches=flow_launches)


def phase_learn(dev) -> dict:
    """The learning run and its closed loop in f32, then in bf16 (see the
    module docstring). → {label: learn_dtype's result}."""
    out = {}
    for label, dtype in LEARN_DTYPES:
        work = tempfile.mkdtemp(prefix=f"chip_smoke_learn_{label}_")
        try:
            allow_tf32()
            out[label] = learn_dtype(label, dtype, work, dev)
            check_f32(f"the learning run and its export ({label})")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print("learn: " + "; ".join(
        f"{lab}: coarse <1_pct_cor {r['coarse'][1]['<1_pct_cor']:.4f}, <1_pct_flow2 "
        f"{r['flow'][1].get('<1_pct_flow2', 0):.4f}, overall trained "
        f"{r['loop']['metrics']['trained']['overall']:.4f} / initial "
        f"{r['loop']['metrics']['initial']['overall']:.4f} mm"
        for lab, r in out.items()) + f"; {smi_line()}", flush=True)
    return out


# tests/test_torch_distributed.py's bars for two ranks against one: losses
# rtol 2e-4; f32 statistics rtol 2e-4 (atol 1e-6) and gradients within 1e-4
# (coarse-only) / 1e-2 (flow) of their max |g|; bf16 statistics within 2⁻⁷
# of their largest magnitude and gradients no further from the one-rank f32
# gradients than twice the one-rank bf16 step's (RMS of relative L2)
DP_BARS = {"rtol": 2e-4, "atol": 1e-6, "grad": {False: 1e-4, True: 1e-2},
           "stats_bf16": 2.0 ** -7, "rms_factor": 2.0}
SHIFT_INVARIANT = ("vol_conv.convs.7.conv.bias", "point_flow.head.layers.1.linear.bias")


def rms_distance(grads: dict, ref: dict) -> float:
    """RMS over the parameters of ‖g − ref‖ / ‖ref‖."""
    d = [float((grads[n] - g).norm()) / float(g.norm()) for n, g in ref.items()
         if n not in SHIFT_INVARIANT and float(g.norm()) > 0]
    return float(np.sqrt(np.mean(np.square(d))))


def dp_cfg(dtype: str):
    """The CPU tests' data-parallel config (tests/torch_dp_worker.py) with
    the kernel's k = 16."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS = cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.NUM_VIRTUAL_PLANE = 16
    cfg.MODEL.MASKED_LOSS = False
    cfg.MODEL.DTYPE = dtype
    return cfg


def dp_step(dtype: str, kw: dict, sd: dict, batch: dict, points, dev) -> dict:
    """One train step of ``dp_cfg`` on ``dev`` from ``sd``, the kNN fed
    ``points`` (or recording its input points when None), every kNN call
    held to the plain version → losses, gradients, BN statistics (CPU),
    the kNN input points."""
    import pointmvsnet_tpu_torch.models.pointmvsnet as mflow
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step, put_batch
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    from pointmvsnet_tpu_torch.ops import knn as knn_op

    cfg = dp_cfg(dtype)
    model = build_model(cfg, dev)
    model.load_state_dict(sd)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    seen = []
    knn_op.launches = 0
    with record_kernel_calls() as calls:
        recorded = mflow.window_knn_idx

        def knn(pts, *args):
            seen.append(pts.detach().cpu())
            return recorded(pts if points is None else points.to(pts.device), *args)

        mflow.window_knn_idx = knn
        state, losses = make_train_step(build_loss_fn(cfg), kw)(state, put_batch(batch, dev))
    check(state.optimizer.count == 1, f"train-dp: the {dtype} step skipped its update")
    if kw["is_flow"]:
        check_kernel_calls(calls, f"train-dp {dtype} step")
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                       for n, p in model.named_parameters()},
                stats={n: b.cpu() for n, b in model.named_buffers() if "running" in n},
                points=seen[0] if seen else None, knn_launches=knn_op.launches)


def dp_rank(rank: int, world: int, store: str, jobs: list, out: str) -> None:
    """A rank of the two-rank check: a gloo group over a FileStore, both
    ranks on cuda:0; each job is one step on the rank's rows."""
    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        results = []
        for job in jobs:
            per = job["batch"]["images"].shape[0] // world
            rows = slice(rank * per, (rank + 1) * per)
            pts = job["points"]
            results.append(dp_step(job["dtype"], job["kw"], job["sd"],
                                   {k: v[rows] for k, v in job["batch"].items()},
                                   None if pts is None else pts[rows], torch.device("cuda", 0)))
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def nccl_one_rank(rank: int, tree: str, out: str, store: str) -> None:
    """train() (2 coarse-only + 2 flow steps with validation, reference
    config, f32) without a process group and inside a one-rank NCCL group,
    with deterministic algorithms; the parameters and buffers of both
    runs to ``out``."""
    import warnings

    import torch.distributed as dist

    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.train import train

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = get_default_cfg()
    for split in ("TRAIN", "VAL"):
        cfg.DATA[split].ROOT_DIR = tree
    cfg.SCHEDULER.INIT_EPOCH = 1
    cfg.SCHEDULER.MAX_EPOCH = 2
    runs = {}

    def run(name):
        state = train(cfg, os.path.join(out, name), max_steps_per_epoch=2, device="cuda")
        runs[name] = {n: t.detach().cpu() for n, t in state.model.state_dict().items()}
        runs[name + "_step"] = state.step

    run("no_group")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        run("nccl_1")
    finally:
        dist.destroy_process_group()
    if not all(same_bits(v, runs["nccl_1"][k]) for k, v in runs["no_group"].items()):
        run("no_group_again")      # is the training itself deterministic here?
    torch.save(runs, os.path.join(out, "runs.pt"))


def phase_train_dp(dev):
    """Data parallelism on the one card. (1) A one-rank NCCL group around
    train() against train() without a group: parameters and buffers
    bit-equal after 2 + 2 steps. (2) Two ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one device) at 64x128, V=3, D=16, global B=4,
    BatchNorm, f32 and bf16, one coarse-only and one flow step, against the
    one-rank step at B=4 on the card, the kNN of both fed the one-rank
    step's kNN input points, with the bars of tests/test_torch_distributed.py.
    A single card cannot show NCCL between cards."""
    import torch.multiprocessing as mp

    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch, make_synthetic_dtu
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import init_params

    import gc
    gc.collect()
    torch.cuda.empty_cache()        # the ranks' processes share the card with this one
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        tree = os.path.join(work, "dtu")
        make_synthetic_dtu(tree, scans=[2, 3, 5], num_views=3, height=512, width=640,
                           num_depth=48)
        t0 = time.perf_counter()
        mp.spawn(nccl_one_rank, args=(tree, work, os.path.join(work, "store1")), nprocs=1,
                 join=True)
        runs = torch.load(os.path.join(work, "runs.pt"), weights_only=False)
        equal = all(same_bits(v, runs["nccl_1"][k]) for k, v in runs["no_group"].items())
        check(runs["no_group_step"] == runs["nccl_1_step"] == 4, f"train-dp: steps {runs}")
        check(equal, "train-dp: the one-rank NCCL run differs from the run without a group "
                     f"(two runs without a group bit-equal: "
                     f"{'no_group_again' in runs and all(same_bits(v, runs['no_group_again'][k]) for k, v in runs['no_group'].items())})")
        print(f"train-dp: train() 640x512 V=3 D=48 B=4 f32, 2 coarse-only + 2 flow steps with "
              f"validation, deterministic algorithms: inside a one-rank NCCL group bit-equal to "
              f"the run without a group ({len(runs['no_group'])} parameters and buffers), "
              f"{time.perf_counter() - t0:.1f} s with the process start", flush=True)

        images, cams, gt = make_scene_batch(4, 3, 64, 128, 16, seed=5)
        images = (images + 3.0 * np.random.RandomState(7).randn(*images.shape)).astype(np.float32)
        batch = {"images": images, "cams": cams, "gt_depth": gt[..., None]}
        sd = init_params(build_model(dp_cfg("float32"), "cpu"), torch.Generator().manual_seed(6))
        sd = {k: v * 1.5 if k.endswith(("conv.weight", "linear.weight", "kernel")) else v
              for k, v in sd.items()}
        configs = [(dtype, is_flow) for dtype in ("float32", "bfloat16") for is_flow in (False, True)]
        jobs, ones, refs = [], [], []
        for dtype, is_flow in configs:
            kw = dict(is_flow=is_flow, img_scales=(0.25,), inter_scales=(0.75,),
                      num_virtual_plane=16)
            one = dp_step(dtype, kw, sd, batch, None, dev)
            ones.append(one)
            # bf16: the one-rank f32 gradients on the same kNN graph
            refs.append(dp_step("float32", kw, sd, batch, one["points"], dev)["grads"]
                        if dtype == "bfloat16" else None)
            jobs.append(dict(dtype=dtype, kw=kw, sd=sd, batch=batch, points=one["points"]))
        mp.spawn(dp_rank, args=(2, os.path.join(work, "store2"), jobs, work), nprocs=2, join=True)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        report = []
        for (dtype, is_flow), one, ref, r0, r1 in zip(configs, ones, refs, *ranks):
            what = f"train-dp {dtype} {'flow' if is_flow else 'coarse-only'}"
            check(r0["losses"] == r1["losses"]
                  and all(torch.equal(v, r1["grads"][k]) for k, v in r0["grads"].items()),
                  f"{what}: the two ranks disagree")
            check(one["knn_launches"] == r0["knn_launches"] == r1["knn_launches"] == int(is_flow),
                  f"{what}: kNN launches {one['knn_launches']}, {r0['knn_launches']}, "
                  f"{r1['knn_launches']}")
            loss_gap = max(abs(r0["losses"][k] - v) / abs(v)
                           for k, v in one["losses"].items() if k.endswith("loss"))
            check(loss_gap <= DP_BARS["rtol"], f"{what}: losses {loss_gap:.2e}")
            if dtype == "float32":
                for n, v in one["stats"].items():
                    check(torch.allclose(r0["stats"][n], v, rtol=DP_BARS["rtol"],
                                         atol=DP_BARS["atol"]), f"{what}: {n}")
                gaps = {n: float((r0["grads"][n] - g).abs().max()) / float(g.abs().max())
                        for n, g in one["grads"].items()
                        if n not in SHIFT_INVARIANT and float(g.abs().max()) > 0}
                worst = max(gaps, key=gaps.get)
                bar = DP_BARS["grad"][is_flow]
                check(gaps[worst] <= bar, f"{what}: grad {worst} {gaps[worst]:.2e} of max |g|")
                grad_note = f"gradients {gaps[worst]:.1e} of max |g| at {worst} (bar {bar:g})"
                stats_note = f"rtol {DP_BARS['rtol']:g} atol {DP_BARS['atol']:g}"
            else:
                for n, v in one["stats"].items():
                    gap = float((r0["stats"][n] - v).abs().max()) / float(v.abs().max())
                    check(gap <= DP_BARS["stats_bf16"], f"{what}: {n} {gap:.2e}")
                two_d, one_d = rms_distance(r0["grads"], ref), rms_distance(one["grads"], ref)
                check(two_d <= DP_BARS["rms_factor"] * one_d,
                      f"{what}: gradients {two_d:.3f} from f32, one rank {one_d:.3f}")
                grad_note = (f"gradients {two_d:.3f} from the one-rank f32 ones (RMS relative "
                             f"L2), one rank's bf16 {one_d:.3f} (bar 2x)")
                stats_note = "2^-7 of max"
            stats_gap = max(float((r0["stats"][n] - v).abs().max()) / float(v.abs().max())
                            for n, v in one["stats"].items())
            report.append(f"{dtype} {'flow' if is_flow else 'coarse'}: losses {loss_gap:.1e} "
                          f"(bar {DP_BARS['rtol']:g}), BN stats {stats_gap:.1e} of max "
                          f"(bar {stats_note}), {grad_note}")
        print(f"train-dp: two ranks on cuda:0 over gloo, 64x128 V=3 D=16 global B=4 BN, against "
              f"one rank at B=4 on the card (1 kNN launch per flow step on each rank, every kNN "
              f"call bit-equal to its plain version): "
              f"{'; '.join(report)}. One card cannot show NCCL between cards.", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def compare_clouds(a: np.ndarray, b: np.ndarray) -> dict:
    """Two fused clouds of one scan, each in the fusion order (reference
    view major, pixels row-major) → counts, and where they are equal the
    largest point gap, the points more than 1e-3 apart and the points
    whose bits differ; else the share of each cloud within 1e-3 of a point
    of the other."""
    out = {"n": (len(a), len(b))}
    if len(a) == len(b):
        gap = np.abs(a - b).max(1) if len(a) else np.zeros(0, np.float32)
        out.update(max_abs=float(gap.max(initial=0.0)), over_1e3=int((gap > 1e-3).sum()),
                   bits_differ=int((a != b).any(1).sum()))
    elif len(a) and len(b):
        from scipy.spatial import cKDTree
        out["matched"] = [float((cKDTree(y).query(x, k=1)[0] <= 1e-3).mean())
                          for x, y in ((a, b), (b, a))]
    return out


def clouds_agree(c: dict) -> bool:
    """The JAX package's bar between its two fusion backends
    (tests/test_postprocess.py::test_fusion_jax_matches_numpy): equal
    point counts, points within 1e-3."""
    return c["n"][0] == c["n"][1] and c["max_abs"] <= 1e-3


def phase_export(weight: str, work: str):
    """The eval pipeline on the card (see the module docstring). →
    launches per exported map (kNN, masked max).

    The smoke-trained weights' probabilities are below the fuse CLI's
    default 0.8 (no point survives), so fusion runs at prob 0 and 2 views.
    It runs three times on the same export: the torch backend on the card,
    the numpy backend, and the torch backend on the CPU; each pair is held
    to the JAX package's bar between its backends (``clouds_agree``)."""
    from pointmvsnet_tpu_torch import fuse, native
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.dtu import DTUTestDataset
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu, plane_depths
    from pointmvsnet_tpu_torch.ops import edge, knn
    from pointmvsnet_tpu_torch.postprocess import read_ply
    from pointmvsnet_tpu_torch.predictor import Predictor

    h, w, views, depths = 640, 800, 5, 96
    tree = os.path.join(work, "dtu_eval")
    t0 = time.perf_counter()
    make_synthetic_dtu(tree, scans=[1], layout="eval", num_views=views, height=h, width=w,
                       num_depth=depths)
    t_tree = time.perf_counter() - t0
    jpgs = sorted(os.path.join(tree, "Eval", "scan1", "images", f) for f in
                  os.listdir(os.path.join(tree, "Eval", "scan1", "images")))
    t_dec, t_enc, nbytes = [], [], []
    for p in jpgs:
        t0 = time.perf_counter()
        img = io.read_jpeg(p)
        t_dec.append(time.perf_counter() - t0)
        check(img.shape == (h, w, 3), f"export: {p} decodes to {img.shape}")
        t0 = time.perf_counter()
        io.write_jpeg(os.path.join(work, "again.jpg"), img)
        t_enc.append(time.perf_counter() - t0)
        nbytes.append(os.path.getsize(p))
    print(f"export: eval tree {w}x{h}, {views} views, D={depths}, in {t_tree:.2f} s; JPEG "
          f"{np.mean(nbytes) / 1e3:.1f} kB per image, read_jpeg {1e3 * np.mean(t_dec):.1f} ms "
          f"and write_jpeg {1e3 * np.mean(t_enc):.1f} ms per image (host, mean of {views}); "
          f"{smi_line()}", flush=True)

    out = os.path.join(work, "export")
    cfg_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "dtu_wde3.yaml")
    args = ["--cfg", cfg_file, "--device", "cuda", "MODEL.DTYPE", "bfloat16",
            "DATA.TEST.ROOT_DIR", tree, "DATA.TEST.NUM_VIEW", str(views),
            "DATA.TEST.NUM_VIRTUAL_PLANE", str(depths), "OUTPUT_DIR", out,
            "TEST.WEIGHT", weight]
    allow_tf32()
    knn.launches = edge.launches = 0
    native.loads.update(pfm=0, cam=0)
    t0 = time.perf_counter()
    summary, depth_dir = test_cli.main(args)
    t_cli = time.perf_counter() - t0
    check_f32("test.test (the test CLI)")
    nk, ne = knn.launches, edge.launches
    cli_cams = native.loads["cam"]
    check(cli_cams > 0, "export: the test CLI read no cam through the C data plane")
    n_maps = summary["maps"]
    check(n_maps == views, f"export: {n_maps} maps, want {views}")
    check(nk == 3 * n_maps and ne == 9 * n_maps,
          f"export: {nk} kNN and {ne} masked-max launches for {n_maps} maps, want 3 and 9 each")
    scan_dir = os.path.join(depth_dir, "scan1")
    want = {f"{v:08d}{s}" for v in range(views)
            for s in ("_init.pfm", "_flow1.pfm", "_flow2.pfm", "_flow3.pfm", "_prob.pfm",
                      ".txt", ".png")}
    check(set(os.listdir(scan_dir)) == want, f"export: files {sorted(os.listdir(scan_dir))}")
    flow3 = io.load_pfm(os.path.join(scan_dir, "00000000_flow3.pfm"))
    check(np.isfinite(flow3).all(), "export: non-finite flow3")
    print(f"export: test CLI bf16, {n_maps} maps of {flow3.shape[1]}x{flow3.shape[0]}: "
          f"{summary['maps_per_s']:.3f} maps/s over the loop, "
          f"{summary['maps_per_s_after_first']:.3f} maps/s after the first map (which "
          f"decodes all {views} views; each view is decoded once), {t_cli:.1f} s with model "
          f"build and weight load; launches per map kNN {nk // n_maps} masked-max "
          f"{ne // n_maps}; C data plane read {cli_cams} cams; {smi_line()}", flush=True)

    # the same item through the serving front end
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(args[4:])
    ds = DTUTestDataset(tree, num_view=views, num_virtual_plane=depths,
                        interval_scale=cfg.DATA.TEST.INTERVAL_SCALE,
                        img_height=cfg.DATA.TEST.IMG_HEIGHT, img_width=cfg.DATA.TEST.IMG_WIDTH)
    item = ds[ds.index.index((1, 0))]
    sd = torch.load(weight, map_location="cpu", weights_only=True)["model"]
    served = Predictor(cfg, sd, device="cuda", normalize=False)(item["images"], item["cams"])
    cam = item["cams"][0]
    span = (depths - 1) * float(cam[1, 3, 1])
    gap = float(np.abs(served["flow3"] - flow3).max())
    check(served["flow3"].shape == flow3.shape and gap <= 1e-3 * span,
          f"export vs serving: flow3 max |Δ| {gap} (bar {1e-3 * span})")
    raw = io.load_cam(os.path.join(tree, "Eval", "scan1", "cams", "00000000_cam.txt"))
    d_lo, d_hi = plane_depths(float(raw[1, 3, 0]), float(raw[1, 3, 1]), depths)
    true3 = np.where(np.arange(flow3.shape[1]) < flow3.shape[1] // 2, d_lo, d_hi)[None, :]
    print(f"export: exported flow3 of view 0 against Predictor on the same item: "
          f"{'bit-equal' if gap == 0 else f'max |Δ| {gap:.3e}'} (bar {1e-3 * span:.3f}, "
          f"1e-3 of the {span:.1f} depth range); its mean |depth − true| "
          f"{float(np.abs(flow3 - true3).mean()):.2f} (planes at {d_lo:.2f} / {d_hi:.2f})",
          flush=True)

    clouds, secs = {}, {}
    native.loads.update(pfm=0, cam=0)
    for label, backend, dev in (("card", "torch", "cuda"), ("numpy", "numpy", "cuda"),
                                ("cpu", "torch", "cpu")):
        t0 = time.perf_counter()
        r = fuse.main(["--depth_dir", depth_dir, "--out", os.path.join(work, f"clouds_{label}"),
                       "--backend", backend, "--device", dev, "--prob_threshold", "0",
                       "--min_views", "2"])["scan1"]
        secs[label] = time.perf_counter() - t0
        check(r["backend"] == backend, f"fuse: scan1 took {r['backend']}")
        clouds[label] = read_ply(r["ply"])[0]
        check(len(clouds[label]) > 0 and np.isfinite(clouds[label]).all(),
              f"fuse {label}: {len(clouds[label])} points, or not finite")
    fuse_read = dict(native.loads)
    check(fuse_read["pfm"] > 0 and fuse_read["cam"] > 0,
          f"fuse: the C data plane read {fuse_read} (PFMs, cams), want both > 0")
    pairs = {f"{a}-{b}": compare_clouds(clouds[a], clouds[b])
             for a, b in (("card", "numpy"), ("card", "cpu"), ("cpu", "numpy"))}
    print(f"export: fuse CLI at prob 0, 2 views, {views} maps of {flow3.shape[1]}x"
          f"{flow3.shape[0]}: torch on the card {secs['card']:.3f} s, numpy "
          f"{secs['numpy']:.3f} s, torch on the CPU {secs['cpu']:.3f} s (CLI wall, PFM reads "
          f"and PLY write included), C data plane read {fuse_read['pfm']} PFMs and "
          f"{fuse_read['cam']} cams; clouds {json.dumps(pairs)}; {smi_line()}", flush=True)
    for name, c in pairs.items():
        check(clouds_agree(c), f"fuse {name}: {c}")
    return nk // n_maps, ne // n_maps


def phase_export_dtu(work: str):
    """The test CLI on DTU's real image size (see the module docstring):
    1600×1200 JPEGs, decoded and resized by the C++ data plane while the
    card runs the forward."""
    from pointmvsnet_tpu_torch import native
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset import io, jpeg
    from pointmvsnet_tpu_torch.dataset.dtu import DTUTestDataset
    from pointmvsnet_tpu_torch.dataset.preprocess import _linear_taps, _resize_linear_py
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
    from pointmvsnet_tpu_torch.ops import edge, knn

    h, w, views, depths = 1200, 1600, 6, 96
    tree = os.path.join(work, "dtu_eval_1600")
    t0 = time.perf_counter()
    make_synthetic_dtu(tree, scans=[1], layout="eval", num_views=views, height=h, width=w,
                       num_depth=depths)
    t_tree = time.perf_counter() - t0
    img_dir = os.path.join(tree, "Eval", "scan1", "images")
    jpgs = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    io.reset_native()
    t_dec = []
    for p in jpgs:
        t0 = time.perf_counter()
        img = io.read_jpeg(p)
        t_dec.append((time.perf_counter() - t0) * 1e3)
        check(img.shape == (h, w, 3), f"export-dtu: {p} decodes to {img.shape}")
    with open(jpgs[0], "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    py = jpeg._decode_jpeg_py(data)
    t_py = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(py, io.read_jpeg(jpgs[0])), "export-dtu: view 0: C decode != Python")
    x = py.astype(np.float32)
    taps = (_linear_taps(480, h), _linear_taps(640, w))
    c_resize = host_ms(lambda: native.resize_linear(x, *taps), 10)
    np_resize = host_ms(lambda: _resize_linear_py(x, *taps), 5)
    print(f"export-dtu: eval tree {w}x{h}, {views} views, D={depths}, written in {t_tree:.1f} s; "
          f"JPEG {np.mean([os.path.getsize(p) for p in jpgs]) / 1e3:.0f} kB per image; host ms: "
          f"read_jpeg C path {np.mean(t_dec):.2f} (mean of {views}, {min(t_dec):.2f}-"
          f"{max(t_dec):.2f}), Python {t_py:.1f} (view 0, once; bit-equal); linear resize "
          f"to 640x480 C {c_resize:.3f} / numpy {np_resize:.3f} (mean); {smi_line()}", flush=True)

    out = os.path.join(work, "export_dtu")
    cfg_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "dtu_wde3.yaml")
    args = ["--cfg", cfg_file, "--device", "cuda", "MODEL.DTYPE", "bfloat16",
            "DATA.TEST.ROOT_DIR", tree, "DATA.TEST.NUM_VIRTUAL_PLANE", str(depths),
            "OUTPUT_DIR", out]
    knn.launches = edge.launches = 0
    native.loads.update(dict.fromkeys(native.loads, 0))
    t0 = time.perf_counter()
    summary, depth_dir = test_cli.main(args)
    t_cli = time.perf_counter() - t0
    nk, ne = knn.launches, edge.launches
    read = dict(native.loads)
    n_maps = summary["maps"]
    check(n_maps == views, f"export-dtu: {n_maps} maps, want {views}")
    check(nk == 3 * n_maps and ne == 9 * n_maps,
          f"export-dtu: {nk} kNN and {ne} masked-max launches for {n_maps} maps, want 3 and 9 "
          f"each")
    check(read["jpeg"] > 0 and read["resize"] > 0 and read["cam"] > 0,
          f"export-dtu: the C data plane read {read}, want JPEGs, resizes and cams > 0")
    flow3 = io.load_pfm(os.path.join(depth_dir, "scan1", "00000000_flow3.pfm"))
    check(flow3.shape == (448, 640) and np.isfinite(flow3).all(),
          f"export-dtu: flow3 {flow3.shape}, finite {np.isfinite(flow3).all()}")
    print(f"export-dtu: test CLI bf16 (configs/dtu_wde3.yaml, weights from RNG_SEED), {n_maps} "
          f"maps of {flow3.shape[1]}x{flow3.shape[0]} from {w}x{h} JPEGs (scale 0.4, base-64 "
          f"crop): {summary['maps_per_s']:.3f} maps/s over the loop, "
          f"{summary['maps_per_s_after_first']:.3f} maps/s after the first map, {t_cli:.1f} s "
          f"with model build; launches per map kNN {nk // n_maps} masked-max {ne // n_maps}; "
          f"the C data plane decoded {read['jpeg']} JPEGs, resized {read['resize']} images and "
          f"read {read['cam']} cams; {smi_line()}", flush=True)

    # one item through the C path and through the Python path
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    t = cfg.DATA.TEST

    def item():
        ds = DTUTestDataset(tree, num_view=t.NUM_VIEW, num_virtual_plane=depths,
                            interval_scale=t.INTERVAL_SCALE, img_height=t.IMG_HEIGHT,
                            img_width=t.IMG_WIDTH)
        t0 = time.perf_counter()
        got = ds[ds.index.index((1, 0))]
        return got, time.perf_counter() - t0

    c_item, c_s = item()
    with python_readers():
        py_item, py_s = item()
    for k in ("images", "cams"):
        check(c_item[k].dtype == py_item[k].dtype and np.array_equal(
            c_item[k].view(np.uint32), py_item[k].view(np.uint32)),
            f"export-dtu: item {k}: C path != PMVS_NO_NATIVE=1")
    print(f"export-dtu: item (scan 1, view 0; {t.NUM_VIEW} views decoded, resized, cropped to "
          f"{c_item['images'].shape[2]}x{c_item['images'].shape[1]} and standardized) bit-equal "
          f"on the C path ({c_s:.3f} s) and with PMVS_NO_NATIVE=1 ({py_s:.3f} s); host clock",
          flush=True)


def phase_weights(work: str):
    """Weights the JAX package loads, on the card (see the module
    docstring). → launches of the request from converted weights (kNN,
    masked max)."""
    import importlib.util

    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.ops import edge, knn
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils import torch_convert
    from pointmvsnet_tpu_torch.utils.orbax_reader import read_orbax

    root = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(root, "configs", "dtu_wde3.yaml")
    # by its path: the card's machine has a site package named "tests"
    spec = importlib.util.spec_from_file_location(
        "torch_mirror", os.path.join(root, "tests", "torch_mirror.py"))
    mirror = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mirror)

    def depth_bars(what, got, want, keys):
        report = []
        for key in keys:
            d = np.abs(got[key] - want[key])
            report.append(f"{key} max {d.max():.3e} mean {d.mean():.3e}")
            check(np.isfinite(got[key]).all() and d.max() < 0.05 and d.mean() < 0.005,
                  f"{what} {key}: max {d.max()} mean {d.mean()}")
        c = float(np.abs(got["coarse_prob_map"] - want["coarse_prob_map"]).max())
        check(c < 0.02, f"{what} confidence: max {c}")
        return f"{'; '.join(report)}; confidence max {c:.3e}"

    # the reference layout at full width, saved as the reference saves it. BN
    # is no identity and the kernels are torch's init ×2: with torch's init
    # alone the outputs do not change when two same-shape tensors of the
    # image or volume stages swap places (my CPU runs); ×2 as the CPU tests
    # draw them (tests/test_torch_model.py KERNEL_SCALE)
    torch.manual_seed(7)
    tm = mirror.TorchPointMVSNet().eval()
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.from_numpy(rng.randn(*m.running_mean.shape) * 0.3))
                m.running_var.copy_(torch.from_numpy(0.5 + rng.rand(*m.running_var.shape)))
                m.weight.copy_(torch.from_numpy(0.5 + rng.rand(*m.weight.shape)))
                m.bias.copy_(torch.from_numpy(rng.randn(*m.bias.shape) * 0.3))
            elif isinstance(m, torch.nn.modules.conv._ConvNd):
                m.weight.mul_(2)
    pth, pt = os.path.join(work, "reference.pth"), os.path.join(work, "converted.pt")
    torch.save({"model": {"module." + k: v for k, v in tm.state_dict().items()}}, pth)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pointmvsnet_tpu_torch.utils.torch_convert",
                    "--pth", pth, "--cfg", cfg_file, "--out", pt], check=True, cwd=root,
                   timeout=600)
    t_cli = time.perf_counter() - t0
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    t0 = time.perf_counter()
    sd = torch_convert.convert_state_dict(torch_convert.load_pth(pth), build_model(cfg, "cpu"))
    t_conv = (time.perf_counter() - t0) * 1e3

    # a paper-eval request from the converted weights, then from the in-process conversion
    cfg.MODEL.DTYPE = "bfloat16"
    h, w = cfg.DATA.TEST.IMG_HEIGHT, cfg.DATA.TEST.IMG_WIDTH
    v, d = cfg.DATA.TEST.NUM_VIEW, cfg.DATA.TEST.NUM_VIRTUAL_PLANE
    images, cams, _ = make_scene_batch(1, v, h, w, d, seed=0)
    pred = Predictor(cfg, weight_path=pt, device="cuda")
    knn.launches = edge.launches = 0
    out = pred(images[0], cams[0])
    nk, ne = knn.launches, edge.launches
    check((nk, ne) == (3, 9), f"weights: {nk} kNN and {ne} masked-max launches, want 3 and 9")
    check(out["flow3"].shape == (h, w) and np.isfinite(out["flow3"]).all(),
          f"weights: flow3 {out['flow3'].shape}, finite {np.isfinite(out['flow3']).all()}")
    del pred
    same = Predictor(cfg, state_dict=sd, device="cuda")(images[0], cams[0])
    check(same_bits(torch.from_numpy(out["depth"]), torch.from_numpy(same["depth"])),
          "weights: the request from the converted .pt differs from the in-process conversion")
    print(f"weights: reference .pth (TorchPointMVSNet, {len(sd)} tensors) -> .pt by the "
          f"convert CLI in {t_cli:.2f} s (a process: start, imports, model build, load, "
          f"save); convert_state_dict {t_conv:.1f} ms in process (host); paper-eval request "
          f"{w}x{h} V={v} D={d} bf16 from the .pt: launches knn {nk} masked_window_max {ne}, "
          f"flow3 finite, depth bit-equal to Predictor(state_dict=convert_state_dict(...))",
          flush=True)

    # f32 at the parity config: the port from the .pt against the mirror's own forward
    cfg32 = get_default_cfg()
    cfg32.DATA.TEST.NUM_VIRTUAL_PLANE = 16
    kw = dict(img_scales=tuple(cfg32.MODEL.TEST.IMG_SCALES),
              inter_scales=tuple(cfg32.MODEL.TEST.INTER_SCALES), num_virtual_plane=16)
    images, cams, _ = make_scene_batch(1, 3, 64, 128, 16)
    got = Predictor(cfg32, weight_path=pt, device="cuda", normalize=False)(images[0], cams[0])
    knn_torch = mirror.window_knn_torch
    try:
        # the mirror builds its kNN candidate table with numpy: that selection
        # runs on the host, on the points the card computed
        mirror.window_knn_torch = lambda pts, *a: knn_torch(pts.cpu(), *a).to(pts.device)
        with torch.device("cuda"), torch.no_grad():
            ref = tm.cuda()(torch.tensor(images).permute(0, 1, 4, 2, 3), torch.tensor(cams),
                            **kw)
    finally:
        mirror.window_knn_torch = knn_torch
    ref = {k: t[0].cpu().numpy() for k, t in ref.items()}
    report = depth_bars("weights: port vs mirror", got, ref,
                        ("coarse_depth_map", "flow1", "flow2", "flow3"))
    moved = [float(np.abs(got[f"flow{i}"] - got[f"flow{i}_input"]).max()) for i in (1, 2, 3)]
    print(f"weights: f32 64x128 V=3 D=16, the port from the converted .pt against the "
          f"reference-layout mirror on the card: {report}; the flows move the depth by at "
          f"most {moved}", flush=True)

    # the orbax checkpoint the JAX package wrote, and its depth
    fixture = os.path.join(root, "tests", "data", "orbax_tiny")
    e = np.load(os.path.join(fixture, "expected.npz"))
    absent = [m for m in ("zstandard", "orbax", "tensorstore", "jax")
              if importlib.util.find_spec(m) is None]
    t0 = time.perf_counter()
    flat = read_orbax(fixture, keys=("params/", "batch_stats/"))
    t_read = (time.perf_counter() - t0) * 1e3
    nbytes = sum(a.nbytes for a in flat.values())
    cfgt = get_default_cfg()
    cfgt.MODEL.IMG_BASE_CHANNELS, cfgt.MODEL.VOL_BASE_CHANNELS = (int(x) for x in e["widths"])
    cfgt.MODEL.TEST.IMG_SCALES = tuple(float(x) for x in e["scales"])
    cfgt.MODEL.TEST.INTER_SCALES = tuple(float(x) for x in e["inter_scales"])
    v, h, w, d = (int(x) for x in e["shape"])
    cfgt.DATA.TEST.NUM_VIRTUAL_PLANE = d
    images, cams, _ = make_scene_batch(1, v, h, w, d, seed=int(e["seed"]))
    got = Predictor(cfgt, weight_path=fixture, device="cuda", normalize=False)(images[0], cams[0])
    want = {k: e[k][0] for k in e.files if e[k].ndim == 3}
    report = depth_bars("weights: orbax fixture", got, want,
                        sorted(k for k in want if k != "coarse_prob_map"))
    print(f"weights: orbax checkpoint of the JAX package (tests/data/orbax_tiny, {len(flat)} "
          f"arrays, {nbytes / 1e3:.1f} kB) read by read_orbax in {t_read:.1f} ms (host; "
          f"not importable here: {absent}); the port on the card at {w}x{h} V={v} D={d} f32 "
          f"against the JAX package's depth: {report}; {smi_line()}", flush=True)
    return nk, ne


# ------------------------------------------------------------ trained

TRAINED_DTYPES = ("float32", "bfloat16")
TRAINED_BF16_BAR = 0.10     # bf16 overall within 10% of f32's


def phase_trained(dev) -> tuple:
    """Export and fusion at the paper-eval config from the checkpoint the
    JAX package trained (tests/data/orbax_trained/), held to the JAX
    package's outputs beside it (expected.npz; tests/test_torch_trained.py
    writes both and holds the small config on the CPU). → launches per f32
    map (kNN, masked max)."""
    from pointmvsnet_tpu_torch import fuse
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu, true_cloud
    from pointmvsnet_tpu_torch.postprocess import write_ply

    root = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(root, "tests", "data", "orbax_trained")
    e = np.load(os.path.join(fixture, "expected.npz"))
    v, h, w, d = (int(x) for x in e["paper_shape"])
    view = int(e["paper_view"])
    prob, min_views = str(float(e["paper_fuse"][0])), str(int(e["paper_fuse"][1]))
    work = tempfile.mkdtemp(prefix="chip_smoke_trained_")
    try:
        tree, gt_tree, gt_dir = (os.path.join(work, n) for n in ("eval", "gt_tree", "gt"))
        scene = dict(scans=[1], num_views=v, height=h, width=w, num_depth=d,
                     seed=int(e["scene_seed"]))
        make_synthetic_dtu(tree, layout="eval", image_ext="png", **scene)
        make_synthetic_dtu(gt_tree, num_lights=1, **scene)
        digest = hashlib.sha256()
        for i in range(v):
            digest.update(io.read_png(os.path.join(tree, "Eval", "scan1", "images",
                                                   f"{i:08d}.png")).tobytes())
        check(digest.hexdigest() == str(e["paper_digest"]),
              "trained: the eval tree's pixels are not those the JAX package's outputs "
              "were computed on")
        gt = true_cloud(gt_tree, v, stride=int(e["paper_gt_stride"]))
        os.makedirs(gt_dir, exist_ok=True)
        write_ply(os.path.join(gt_dir, "scan1.ply"), gt)
        runs = {}
        for dtype in TRAINED_DTYPES:
            reset_launches()
            t0 = time.perf_counter()
            with forbid_plain_on_cuda():
                summary, depth_dir = test_cli.main([
                    "--cfg", os.path.join(root, "configs", "dtu_wde3.yaml"), "--device",
                    dev.type, "MODEL.DTYPE", dtype, "DATA.TEST.ROOT_DIR", tree,
                    "DATA.TEST.NUM_VIEW", str(v), "DATA.TEST.NUM_VIRTUAL_PLANE", str(d),
                    "DATA.TEST.IMG_HEIGHT", str(h), "DATA.TEST.IMG_WIDTH", str(w),
                    "DATA.TEST.INTERVAL_SCALE", str(float(e["interval_scale"])),
                    "MODEL.TEST.IMG_SCALES", str(tuple(float(x) for x in e["img_scales"])),
                    "MODEL.TEST.INTER_SCALES", str(tuple(float(x) for x in e["inter_scales"])),
                    "OUTPUT_DIR", os.path.join(work, dtype), "TEST.WEIGHT", fixture])
            t_cli = time.perf_counter() - t0
            n = summary["maps"]
            counts = launch_counts()
            check(n == v and tuned_only(counts, (3 * n, 9 * n)),
                  f"trained {dtype}: {n} maps, launches {counts}, want {v} maps and 3 kNN "
                  f"(tuned) and 9 masked max per map")
            stem = os.path.join(depth_dir, "scan1", f"{view:08d}")
            maps = {k: io.load_pfm(f"{stem}_{k}.pfm") for k in ("flow3", "prob")}
            check(maps["flow3"].shape == (h, w) and all(np.isfinite(m).all()
                                                        for m in maps.values()),
                  f"trained {dtype}: flow3 {maps['flow3'].shape}, or not finite")
            t0 = time.perf_counter()
            r = fuse.main(["--depth_dir", depth_dir, "--out", os.path.join(work, f"clouds_{dtype}"),
                           "--backend", "torch", "--device", dev.type, "--prob_threshold", prob,
                           "--min_views", min_views, "--gt_dir", gt_dir])["scan1"]
            t_fuse = time.perf_counter() - t0
            check(r["backend"] == "torch" and r["n_points"] > 0 and
                  all(np.isfinite(r[k]) for k in ("accuracy", "completeness", "overall")),
                  f"trained {dtype}: fused {r}")
            runs[dtype] = dict(maps=maps, fused=r,
                               per_map={k: c // n for k, c in counts.items()})
            print(f"trained: {dtype} test CLI from tests/data/orbax_trained at {w}x{h} V={v} "
                  f"D={d}: {n} maps, {summary['maps_per_s']:.3f} maps/s over the loop, "
                  f"{summary['maps_per_s_after_first']:.3f} after the first map, {t_cli:.1f} s "
                  f"with model build and weight load; launches per map "
                  f"{runs[dtype]['per_map']}; fuse CLI (torch on the card, prob {prob}, "
                  f"{min_views} views, --gt_dir with {len(gt)} true points) {t_fuse:.2f} s: "
                  f"{r['n_points']} points, accuracy {r['accuracy']:.4f} completeness "
                  f"{r['completeness']:.4f} overall {r['overall']:.4f} mm; {smi_line()}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    f32, bf16 = runs["float32"], runs["bfloat16"]
    dd = np.abs(f32["maps"]["flow3"] - e["paper_flow3"][0])
    dp = np.abs(f32["maps"]["prob"] - e["paper_prob"][0])
    n_want, *m_want = (float(x) for x in e["paper_fused"])
    m_got = [f32["fused"][k] for k in ("accuracy", "completeness", "overall")]
    rel = [abs(a - b) / b for a, b in zip(m_got, m_want)]
    n_rel = abs(f32["fused"]["n_points"] - n_want) / n_want
    bf = abs(bf16["fused"]["overall"] - f32["fused"]["overall"]) / f32["fused"]["overall"]
    print(f"trained: f32 on the card against the JAX package on the CPU (expected.npz): "
          f"view {view} flow3 max |Δ| {dd.max():.3e} mean {dd.mean():.3e} (bars 0.05 / 0.005), "
          f"prob max |Δ| {dp.max():.3e} (bar 0.02); fused n_points {f32['fused']['n_points']} "
          f"vs {int(n_want)} ({100 * n_rel:.3f}%, bar 1%), accuracy / completeness / overall "
          f"{[round(x, 4) for x in m_got]} vs {[round(x, 4) for x in m_want]} "
          f"({[round(100 * x, 3) for x in rel]}%, bar 2%); bf16 overall "
          f"{bf16['fused']['overall']:.4f} vs f32 {f32['fused']['overall']:.4f} "
          f"({100 * bf:.2f}%, bar {100 * TRAINED_BF16_BAR:.0f}%); {smi_line()}", flush=True)
    check(dd.max() < 0.05 and dd.mean() < 0.005, f"trained: f32 flow3 max {dd.max()} mean "
          f"{dd.mean()} against the JAX package's")
    check(dp.max() < 0.02, f"trained: f32 prob max {dp.max()} against the JAX package's")
    check(n_rel <= 0.01 and max(rel) <= 0.02,
          f"trained: f32 fused n_points {n_rel:.4%} and metrics {rel} off the JAX package's")
    check(bf <= TRAINED_BF16_BAR, f"trained: bf16 overall {bf:.2%} off f32's")
    return tuple(f32["per_map"][k] for k in ("window_knn", "masked_window_max"))


def fusion_scan_scene():
    """49 depth maps of 640×512 (the DTU eval release's view count, at the
    paper-eval map size) of the two-plane scene, seen by cameras on a 7×7
    grid 5.1 apart: each map the scene's true depth plus N(0, 0.05²)
    noise, probabilities uniform in [0.5, 1). → (depths, cams, probs,
    (d_lo, d_hi), focal length)."""
    from pointmvsnet_tpu_torch.dataset.synthetic import plane_depths

    h, w, f, step = 512, 640, 768.0, 425.0 * 0.012
    d_lo, d_hi = plane_depths(425.0, 2.5, 96)
    # the planes are what camera 0 sees: the left half at d_lo, the right at d_hi
    extent = {d_lo: (-w / 2 * d_lo / f, 0.0), d_hi: (0.0, w / 2 * d_hi / f)}
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    depths, cams, probs = [], [], []
    for gy in range(-3, 4):
        for gx in range(-3, 4):
            cam = np.zeros((2, 4, 4), np.float32)
            cam[0] = np.eye(4)
            cam[0, :2, 3] = -gx * step, -gy * step
            cam[1, :3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
            cam[1, 3] = [425.0, 2.5, 96, 425.0 + 95 * 2.5]
            d = np.zeros((h, w))
            for z in (d_hi, d_lo):                    # the nearer plane last: it occludes
                x_w = (xs - w / 2) * z / f + gx * step
                y_w = (ys - h / 2) * z / f + gy * step
                d[(x_w >= extent[z][0]) & (x_w < extent[z][1])
                  & (np.abs(y_w) <= h / 2 * z / f)] = z
            d = np.where(d > 0, d + rng.randn(h, w) * 0.05, 0.0)
            depths.append(d.astype(np.float32))
            cams.append(cam)
            probs.append((0.5 + 0.5 * rng.rand(h, w)).astype(np.float32))
    return depths, cams, probs, (d_lo, d_hi), f


def phase_fusion_scan():
    """Both fusion backends on ``fusion_scan_scene`` at the fuse CLI's
    defaults (prob > 0.8, 3 views) and its view graph (every other map):
    times, the card's peak memory, and each cloud against the scene's
    planes (``point_cloud_metrics`` and the distance to the nearer plane).

    The card is held to the torch backend on the CPU (``clouds_agree``)
    on the centre 3×3 cameras: the same operations, so the card's
    arithmetic is the CPU's. The card against numpy on all 49 maps is
    printed, not held to that bar: numpy's BLAS rounds the projection
    differently in the last bit, and a projected coordinate within that
    bit of a half pixel then samples the neighbouring pixel (PERF.md §6
    traces one such point); with noisy maps that moves a fused depth by
    up to a few hundredths."""
    from pointmvsnet_tpu_torch.postprocess import fuse_depth_maps, point_cloud_metrics
    from pointmvsnet_tpu_torch.postprocess.fusion_torch import fuse_depth_maps_torch

    t0 = time.perf_counter()
    depths, cams, probs, (d_lo, d_hi), f = fusion_scan_scene()
    t_scene = time.perf_counter() - t0
    h, w = depths[0].shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    centre = [r * 7 + c for r in (2, 3, 4) for c in (2, 3, 4)]
    sub = ([depths[i] for i in centre], [cams[i] for i in centre])
    sub_probs = [probs[i] for i in centre]
    c9 = compare_clouds(fuse_depth_maps_torch(*sub, probs=sub_probs, device="cuda")[0],
                        fuse_depth_maps_torch(*sub, probs=sub_probs, device="cpu")[0])
    print(f"fusion-scan: centre 9 of the 49 maps, torch on the card against torch on the "
          f"CPU: {json.dumps(c9)}", flush=True)
    check(clouds_agree(c9), f"fusion-scan: card against CPU {c9}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        pts, _ = fuse_depth_maps_torch(depths, cams, probs=probs, device="cuda")
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    t0 = time.perf_counter()
    npts, _ = fuse_depth_maps(depths, cams, probs=probs)
    t_np = time.perf_counter() - t0
    c = compare_clouds(pts, npts)
    gt_d = np.where(xs < w / 2, d_lo, d_hi).ravel()
    gt = np.stack([(xs.ravel() - w / 2) * gt_d / f, (ys.ravel() - h / 2) * gt_d / f, gt_d],
                  -1).astype(np.float32)
    quality = {}
    for name, cloud in (("card", pts), ("numpy", npts)):
        check(len(cloud) > 0 and np.isfinite(cloud).all(), f"fusion-scan {name}: {len(cloud)} points")
        t0 = time.perf_counter()
        m = point_cloud_metrics(cloud[::16], gt)
        z_err = np.minimum(np.abs(cloud[:, 2] - d_lo), np.abs(cloud[:, 2] - d_hi))
        quality[name] = dict(m, z_err_mean=float(z_err.mean()), z_err_max=float(z_err.max()),
                             seconds=time.perf_counter() - t0)
        # each fused depth averages at least 4 maps' N(0, 0.05²) noise; a point on its
        # plane lies within s/√2 of camera 0's pixel grid, of spacing s ≤ d_hi / f
        check(z_err.mean() < 0.05, f"fusion-scan {name}: mean |z − plane| {z_err.mean()}")
        check(m["accuracy"] < 0.75 * d_hi / f, f"fusion-scan {name}: accuracy {m['accuracy']}")
    print(f"fusion-scan: 49 maps of {w}x{h} (scene built in {t_scene:.1f} s), prob > 0.8, "
          f"3 views, all 48 others as sources: {len(pts)} points; torch on the card "
          f"{times[0]:.3f} s first call, {times[1]:.3f} s second (host to host: stacking, "
          f"copies, the sweep, the masks), peak device memory {peak:.2f} GiB above the "
          f"{base / 2 ** 30:.2f} GiB held before; numpy {t_np:.3f} s; card against numpy "
          f"{json.dumps(c)}; every 16th point against the planes as camera 0's pixels give "
          f"them, and every point's |z − nearer plane|: {json.dumps(quality)}; {smi_line()}",
          flush=True)


# ------------------------------------------------------------ parallel-eval

PE_CHUNKS = (0, 64, 128)          # FLOW_CHUNK_ROWS of the banded serial requests
PE_BAND_CR = 64                   # the band-parallel request's
PE_VIEW_V = 4                     # the view-parallel request's view count (2 divides it)
PE_BARS = {"max": 0.05, "mean": 0.005, "rtol": 1e-4, "atol": 1e-4}


def n_bands(h: int, cr: int) -> int:
    """Bands of a flow map of ``h`` rows at FLOW_CHUNK_ROWS ``cr``."""
    return 1 if cr <= 0 or h <= cr + 16 else h // cr


def pe_cfg(chunk_rows: int):
    """The paper-eval config in bf16 with a band height."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    return cfg


def cupti_ms(fn, kernel: str, tries: int = 3):
    """``device_ms``, tried again while the profiler returns no device time
    for the kernel (late in a run CUPTI sometimes does, and the fallback's
    CUDA events then time the host's launches of a kernel shorter than
    them)."""
    for _ in range(tries):
        ms, how = device_ms(fn, kernel)
        if how == "cupti":
            break
    return ms, how


def time_kernel_calls(calls, shapes: dict) -> dict:
    """Device time of each kernel at the first recorded call of every
    shape not yet in ``shapes``, its plain version's time and the bound of
    the work → ``shapes[(name, grid, F, dtype)] = (ms, plain_ms, bound_ms,
    bound_by, "cupti" | "events")``. → {name: (ms, plain_ms, bound_ms)
    summed over ``calls``, and the sources of the kernel times)}."""
    from pointmvsnet_tpu_torch.ops.edge import masked_window_max_cuda, masked_window_max_plain
    from pointmvsnet_tpu_torch.ops.knn import window_knn, window_knn_cuda

    totals = {"window_knn": [0.0] * 3, "masked_window_max": [0.0] * 3}
    sources: dict = {}
    for attr, args, _, _ in calls:
        if attr == "window_knn_mask":
            pts, grid = args[0], args[1]
            key = ("window_knn", grid, 3, "f32")
            if key not in shapes:
                ms, how = cupti_ms(lambda: window_knn_cuda(pts, grid), "window_knn_kernel")
                pms = time_ms(lambda: window_knn(pts, grid, K, WIN, with_mask=True), reps=2,
                              warmup=1)
                shapes[key] = (ms, pms, *bound_ms(*knn_bound(grid[1], grid[2])), how)
        elif attr == "masked_window_max":
            z, mask, grid = args[0], args[1], args[2]
            key = ("masked_window_max", grid, z.shape[2], str(z.dtype)[6:])
            if key not in shapes:
                ms, how = cupti_ms(lambda: masked_window_max_cuda(z, mask, grid),
                                   "masked_window_max_kernel")
                pms = time_ms(lambda: masked_window_max_plain(z, mask, grid), reps=2, warmup=1)
                shapes[key] = (ms, pms, *bound_ms(*mwm_bound(z, mask)), how)
        else:
            continue
        totals[key[0]] = [t + x for t, x in zip(totals[key[0]], shapes[key][:3])]
        sources.setdefault(key[0], set()).add(shapes[key][4])
    return {k: (*t, "+".join(sorted(sources.get(k, ())))) for k, t in totals.items()}


def pe_rank(rank: int, world: int, store: str, jobs: list, out: str) -> None:
    """A rank of the parallel-eval checks: a gloo group over a FileStore,
    every rank on cuda:0 (NCCL refuses two ranks on one device); each job
    is a request through ``Predictor(grid=)`` or a run of the test CLI."""
    import torch.distributed as dist

    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.ops import edge, knn
    from pointmvsnet_tpu_torch.parallel import distributed
    from pointmvsnet_tpu_torch.predictor import Predictor

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        results = []
        for job in jobs:
            if job["kind"] == "cli":
                results.append(test_cli.main(job["args"]))
                continue
            grid = distributed.make_eval_grid(*job["grid"], device="cuda:0")
            pred = Predictor(pe_cfg(job["chunk_rows"]), device="cuda:0", grid=grid)
            pred(job["images"], job["cams"])
            knn.launches = edge.launches = 0
            t0 = time.perf_counter()
            res = pred(job["images"], job["cams"])
            ms = (time.perf_counter() - t0) * 1e3
            results.append(dict(preds=res, launches=(knn.launches, edge.launches), ms=ms,
                                index=grid.index))
            del pred
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def pe_spawn(jobs: list, world: int, work: str) -> list:
    import torch.multiprocessing as mp
    sub = tempfile.mkdtemp(prefix=f"ranks{world}_", dir=work)
    mp.spawn(pe_rank, args=(world, os.path.join(sub, "store"), jobs, sub), nprocs=world,
             join=True)
    return [torch.load(os.path.join(sub, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def phase_parallel_eval(dev) -> dict:
    """Banded PointFlow and band- and view-parallel eval. (1) The paper-eval
    request (640x512, V=5, D=96, bf16, BN eval) through Predictor at
    FLOW_CHUNK_ROWS 0, 64 and 128: launches, latency, peak memory, the
    per-stage latencies, every kernel call of a banded request bit-equal
    to its plain version and timed at its band grid, and the banded depth
    against the unbanded depth (tests/test_full_parity.py's bars). (2) Two
    ranks on cuda:0 over gloo, grid (1, 2, 1), FLOW_CHUNK_ROWS 64: each
    rank's answer bit-equal to the serial banded request. (3) Two ranks,
    grid (1, 1, 2), V=4: within rtol / atol 1e-4 of the serial request at
    V=4 (tests/test_parallel.py's bars). (4) The test CLI on four ranks,
    grid (1, 2, 2), 64x128, V=4, D=16, f32, FLOW_CHUNK_ROWS 16: its PFMs
    within 1e-4 of the one-rank export. A single card cannot show NCCL
    between cards, nor a speed-up: the ranks share it. → {kernel: launches
    per banded request (FLOW_CHUNK_ROWS 64)} and the band-grid timings."""
    import gc

    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch, make_synthetic_dtu
    from pointmvsnet_tpu_torch.ops import edge, knn
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils.profiler import stage_latencies

    cfg0 = pe_cfg(0)
    h, w = cfg0.DATA.TEST.IMG_HEIGHT, cfg0.DATA.TEST.IMG_WIDTH
    v, d = cfg0.DATA.TEST.NUM_VIEW, cfg0.DATA.TEST.NUM_VIRTUAL_PLANE
    scales = tuple(cfg0.MODEL.TEST.IMG_SCALES)
    images, cams, _ = make_scene_batch(1, v, h, w, d, seed=0)
    res, shapes = {}, {}
    for cr in PE_CHUNKS:
        pred = Predictor(pe_cfg(cr), device="cuda")
        pred(images[0], cams[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        knn.launches = edge.launches = 0
        for _ in range(3):
            t0 = time.perf_counter()
            out = pred(images[0], cams[0])
            lat.append((time.perf_counter() - t0) * 1e3)
        nk, ne = knn.launches, edge.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bands = [n_bands(int(h * s), cr) for s in scales]
        want = (3 * sum(bands), 3 * len(EDGE_F) * sum(bands))
        check((nk, ne) == want, f"parallel-eval FLOW_CHUNK_ROWS={cr}: {nk} kNN and {ne} "
                                f"masked-max launches in 3 requests, want {want}")
        check(all(np.isfinite(a).all() for a in out.values()),
              f"parallel-eval FLOW_CHUNK_ROWS={cr}: non-finite output")
        note, totals = "", None
        if cr:
            with record_kernel_calls() as calls:
                again = pred(images[0], cams[0])
            torch.cuda.synchronize()
            check(all(same_bits(torch.from_numpy(again[k]), torch.from_numpy(a))
                      for k, a in out.items()),
                  f"parallel-eval FLOW_CHUNK_ROWS={cr}: a second request differs")
            met = check_kernel_calls(calls, f"parallel-eval FLOW_CHUNK_ROWS={cr}")
            note = f"; kernel calls bit-equal to their plain versions ({met})"
            totals = time_kernel_calls(calls, shapes)
            note += "; per request kernel / plain / bound ms " + ", ".join(
                f"{k} {t[0]:.4f} ({t[3]}) / {t[1]:.1f} / {t[2]:.4f}" for k, t in totals.items())
        stages = stage_latencies(pred.model, torch.tensor(images, device=dev),
                                 torch.tensor(cams, device=dev), scales,
                                 tuple(cfg0.MODEL.TEST.INTER_SCALES), d, iters=3)
        res[cr] = dict(out=out, lat=lat, peak=peak, launches=(nk // 3, ne // 3), totals=totals)
        print(f"parallel-eval: FLOW_CHUNK_ROWS={cr} ({'x'.join(map(str, bands))} bands at "
              f"flow1-3): {w}x{h} V={v} D={d} bf16 latency ms {[round(t, 1) for t in lat]}, "
              f"max_memory_allocated {peak:.2f} GiB, launches per request kNN {nk // 3} "
              f"masked_window_max {ne // 3}; stage_latencies ms "
              f"{ {k: round(1e3 * t, 1) for k, t in stages.items()} }{note}; {smi_line()}",
              flush=True)
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    for cr in PE_CHUNKS[1:]:
        rep = []
        for key in ("coarse_depth_map", "flow1", "flow2", "flow3"):
            diff = np.abs(res[cr]["out"][key] - res[0]["out"][key])
            check(diff.max() < PE_BARS["max"] and diff.mean() < PE_BARS["mean"],
                  f"parallel-eval: FLOW_CHUNK_ROWS={cr} {key} max {diff.max()} "
                  f"mean {diff.mean()}")
            rep.append(f"{key} max {diff.max():.3e} mean {diff.mean():.3e} "
                       f"bit-equal {bool(np.array_equal(res[cr]['out'][key], res[0]['out'][key]))}")
        print(f"parallel-eval: FLOW_CHUNK_ROWS={cr} against unbanded (bars max 0.05, mean "
              f"0.005): {'; '.join(rep)}", flush=True)
    for (name, grid, f, dt), (ms, pms, bb, by, how) in sorted(shapes.items()):
        print(f"parallel-eval: {name} band grid {grid} F={f} {dt}: kernel {ms:.4f} ms ({how}), "
              f"plain {pms:.3f} ms, bound {bb:.4f} ms ({by})", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_pe_")
    try:
        # (2) band-parallel and (3) view-parallel, two ranks sharing the card
        torch.cuda.empty_cache()
        img4, cam4, _ = make_scene_batch(1, PE_VIEW_V, h, w, d, seed=0)
        serial4 = Predictor(pe_cfg(0), device="cuda")(img4[0], cam4[0])
        gc.collect()
        torch.cuda.empty_cache()
        jobs = [dict(kind="predict", grid=(1, 2, 1), chunk_rows=PE_BAND_CR,
                     images=images[0], cams=cams[0]),
                dict(kind="predict", grid=(1, 1, 2), chunk_rows=0, images=img4[0],
                     cams=cam4[0])]
        t0 = time.perf_counter()
        ranks = pe_spawn(jobs, 2, work)
        t_ranks = time.perf_counter() - t0
        serial = res[PE_BAND_CR]["out"]
        # rank r refines bands [r·⌈P/2⌉, (r+1)·⌈P/2⌉) of each flow's P, and
        # every rank a flow too short to band
        per_rank = [sum(1 if n == 1 else max(0, min(n, (r + 1) * -(-n // 2)) - r * -(-n // 2))
                        for n in (n_bands(int(h * s), PE_BAND_CR) for s in scales))
                    for r in range(2)]
        for r, (band, view) in enumerate(ranks):
            check(all(same_bits(torch.from_numpy(band["preds"][k]), torch.from_numpy(a))
                      for k, a in serial.items()),
                  f"parallel-eval: band rank {r} differs from the serial banded request")
            check(band["launches"] == (per_rank[r], len(EDGE_F) * per_rank[r]),
                  f"parallel-eval: band rank {r} launched {band['launches']} kNN / masked-max, "
                  f"want {per_rank[r]} kNN")
        rep = []
        for key in ("coarse_depth_map", "flow3"):
            for r, (_, view) in enumerate(ranks):
                ok = np.allclose(view["preds"][key], serial4[key], rtol=PE_BARS["rtol"],
                                 atol=PE_BARS["atol"])
                diff = np.abs(view["preds"][key] - serial4[key])
                check(ok, f"parallel-eval: view rank {r} {key} max |d| {diff.max()}")
            rep.append(f"{key} max {diff.max():.3e} mean {diff.mean():.3e}")
        check(np.array_equal(ranks[0][1]["preds"]["flow3"], ranks[1][1]["preds"]["flow3"]),
              "parallel-eval: the view ranks disagree")
        print(f"parallel-eval: band-parallel grid (1, 2, 1) FLOW_CHUNK_ROWS={PE_BAND_CR}, two "
              f"gloo ranks on cuda:0: both ranks bit-equal to the serial banded request; kNN / "
              f"masked-max launches per rank {[b['launches'] for b, _ in ranks]}; request ms "
              f"{[round(b['ms'], 1) for b, _ in ranks]}. view-parallel grid (1, 1, 2) V="
              f"{PE_VIEW_V}: against the serial request (bars rtol 1e-4 atol 1e-4): "
              f"{'; '.join(rep)}; request ms {[round(x['ms'], 1) for _, x in ranks]}; "
              f"{t_ranks:.1f} s with the process starts", flush=True)

        # (4) the test CLI on a (1, 2, 2) grid of four ranks
        tree = os.path.join(work, "dtu")
        make_synthetic_dtu(tree, scans=[1], num_views=4, height=64, width=128, num_depth=16,
                           layout="eval")
        args = ["--device", "cuda:0", "DATA.TEST.ROOT_DIR", tree, "DATA.TEST.NUM_VIEW", "4",
                "DATA.TEST.NUM_VIRTUAL_PLANE", "16", "DATA.TEST.IMG_HEIGHT", "64",
                "DATA.TEST.IMG_WIDTH", "128", "DATA.TEST.INTERVAL_SCALE", "1.0",
                "MODEL.FLOW_CHUNK_ROWS", "16"]
        one, one_dir = test_cli.main(args + ["OUTPUT_DIR", os.path.join(work, "one")])
        t0 = time.perf_counter()
        grid_runs = pe_spawn([dict(kind="cli", args=args + [
            "PARALLEL.BAND", "2", "PARALLEL.VIEW", "2", "OUTPUT_DIR",
            os.path.join(work, "grid")])], 4, work)
        t_cli = time.perf_counter() - t0
        summaries = [r[0][0] for r in grid_runs]
        grid_dir = grid_runs[0][0][1]
        check(one["maps"] == 4 and all(s["maps"] == 4 for s in summaries),
              f"parallel-eval: maps {one['maps']} / {[s['maps'] for s in summaries]}")
        names = sorted(os.listdir(os.path.join(one_dir, "scan1")))
        check(sorted(os.listdir(os.path.join(grid_dir, "scan1"))) == names,
              "parallel-eval: the grid's export has other files")
        worst = 0.0
        for f in names:
            if f.endswith(".pfm"):
                a = io.load_pfm(os.path.join(grid_dir, "scan1", f))
                b = io.load_pfm(os.path.join(one_dir, "scan1", f))
                check(np.allclose(a, b, rtol=PE_BARS["rtol"], atol=PE_BARS["atol"]),
                      f"parallel-eval: {f} max |d| {np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
        print(f"parallel-eval: test CLI on a (1, 2, 2) grid of four gloo ranks on cuda:0, "
              f"64x128 V=4 D=16 f32 FLOW_CHUNK_ROWS 16: {summaries[0]['maps']} maps, "
              f"{len(names)} files as the one-rank export, PFMs max |d| {worst:.3e} (bars rtol "
              f"1e-4 atol 1e-4); {t_cli:.1f} s with the process starts. One card cannot show "
              f"NCCL between cards.", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    band = res[PE_BAND_CR]
    return {name: dict(launches=band["launches"][i], ms=band["totals"][name][0],
                       source=band["totals"][name][3])
            for i, name in enumerate(("window_knn", "masked_window_max"))}


def host_ms(fn, reps: int) -> float:
    """Mean host time of ``fn`` over ``reps`` calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def sweep_cam_text(rng) -> str:
    """A cam.txt whose numbers are as write_cam writes a float32 (its repr)
    or carry 1-9 significant digits; a depth line of 1-4 numbers."""
    def num(lo, hi):
        x = rng.uniform(lo, hi)
        digits = rng.randint(0, 10)
        return repr(float(np.float32(x))) if digits == 0 else f"{x:.{digits}g}"
    ext = [" ".join(num(-1, 1) for _ in range(3)) + " " + num(-800, 800) for _ in range(3)]
    k = [f"{num(100, 3000)} 0.0 {num(0, 2000)}", f"0.0 {num(100, 3000)} {num(0, 2000)}",
         "0.0 0.0 1.0"]
    depth = [num(0.1, 1000), num(0.001, 10), str(rng.choice([48, 96, 128, 192])),
             num(100, 3000)][:rng.randint(1, 5)]
    return "\n".join(["extrinsic", *ext, "0.0 0.0 0.0 1.0", "", "intrinsic", *k, "",
                      " ".join(depth)]) + "\n"


@contextlib.contextmanager
def python_readers():
    """PMVS_NO_NATIVE=1 inside the block: the port's Python readers, JPEG
    decoder, PNG unfilter and linear resize."""
    from pointmvsnet_tpu_torch.dataset import io
    os.environ["PMVS_NO_NATIVE"] = "1"
    io.reset_native()
    try:
        yield
    finally:
        os.environ.pop("PMVS_NO_NATIVE", None)
        io.reset_native()


def loader_items_per_s(cfg, native_on: bool) -> tuple:
    """One epoch of ``build_data_loader(cfg, "train")`` with the C path on or
    off (PMVS_NO_NATIVE=1) → (items/s, items, {kind: files the C path read})."""
    from pointmvsnet_tpu_torch import native
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.build import build_data_loader
    before = dict(native.loads)
    with contextlib.nullcontext() if native_on else python_readers():
        io.reset_native()
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in build_data_loader(cfg, "train"))
        secs = time.perf_counter() - t0
    return n / secs, n, {k: native.loads[k] - before[k] for k in before}


def texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8, C-contiguous as a decoded image: the synthetic
    scenes' smooth texture with pixel noise."""
    from pointmvsnet_tpu_torch.dataset.synthetic import _texture
    return np.ascontiguousarray(_texture(np.random.RandomState(seed), h, w))


def phase_dataplane_images(work: str, up_png: str):
    """The image path of the C++ data plane (native/src/image.cpp) on this
    host: JPEG decode at 1600×1200 and 800×640, PNG read with Up and with
    Paeth rows at 640×512, the linear resize 1600×1200 → 640×480; each
    bit-equal to the Python path, and host ms of both (mean; the slow
    Python decode once)."""
    from pointmvsnet_tpu_torch import native
    from pointmvsnet_tpu_torch.dataset import io, jpeg
    from pointmvsnet_tpu_torch.dataset.preprocess import (
        _linear_taps,
        _resize_linear_py,
        resize_image,
    )

    def read_bytes(path):
        with open(path, "rb") as f:
            return f.read()

    parts = []
    for h, w in ((1200, 1600), (640, 800)):
        path = os.path.join(work, f"texture{w}.jpg")
        io.write_jpeg(path, texture(h, w))
        data = read_bytes(path)
        before = native.loads["jpeg"]
        c_ms = host_ms(lambda: io.read_jpeg(path), 10)
        check(native.loads["jpeg"] == before + 11, "dataplane: read_jpeg did not take the C path")
        t0 = time.perf_counter()
        py = jpeg._decode_jpeg_py(data)
        py_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(io.read_jpeg(path), py), f"dataplane: JPEG {w}x{h}: C != Python")
        parts.append(f"JPEG {w}x{h} ({len(data) / 1e3:.0f} kB, write_jpeg) C {c_ms:.3f} / "
                     f"Python {py_ms:.1f} ({py_ms / c_ms:.1f}x)")

    paeth_png = os.path.join(work, "paeth.png")
    io.write_png(paeth_png, io.read_png(up_png), filters=4)
    for label, path in (("Up", up_png), ("Paeth", paeth_png)):
        before = native.loads["png"]
        c_ms = host_ms(lambda: io.read_png(path), 20)
        check(native.loads["png"] == before + 21, "dataplane: read_png did not take the C path")
        c_img = io.read_png(path)
        with python_readers():
            py_ms = host_ms(lambda: io.read_png(path), 3)
            check(np.array_equal(io.read_png(path), c_img), f"dataplane: PNG {label}: C != Python")
        parts.append(f"read_png {c_img.shape[1]}x{c_img.shape[0]} {label} rows C {c_ms:.3f} / "
                     f"Python {py_ms:.3f} ({py_ms / c_ms:.1f}x)")

    x = texture(1200, 1600).astype(np.float32)
    taps = (_linear_taps(480, 1200), _linear_taps(640, 1600))
    before = native.loads["resize"]
    c_ms = host_ms(lambda: resize_image(x, (480, 640), "linear"), 10)
    check(native.loads["resize"] == before + 11, "dataplane: resize_image took no C path")
    py_ms = host_ms(lambda: _resize_linear_py(x, *taps), 5)
    c_out, py_out = resize_image(x, (480, 640), "linear"), _resize_linear_py(x, *taps)
    check(np.array_equal(c_out.view(np.uint32), py_out.view(np.uint32)),
          "dataplane: linear resize: C != numpy")
    parts.append(f"linear resize 1600x1200x3 f32 -> 640x480 C {c_ms:.3f} / numpy {py_ms:.3f} "
                 f"({py_ms / c_ms:.1f}x)")
    print("dataplane: image path bit-equal to the Python path on this host; host ms, C path / "
          "Python (mean): " + "; ".join(parts) + f"; {smi_line()}", flush=True)


def phase_dataplane():
    """The C++ host data plane (native/src/dataplane.cpp) on this host: the
    build; the C path against the Python readers bit for bit on the
    reference train tree at 640×512, on 3-channel and scaled PFMs and on
    2000 seeded cam files; host times of both paths and of the DTU train
    loader (host clock, files in the page cache)."""
    from pointmvsnet_tpu_torch import native
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu

    built = not native.lib_path().exists()
    t0 = time.perf_counter()
    lib = native.build()
    print(f"dataplane: {native.CXX} {native.compiler_version()} {' '.join(native.CXX_FLAGS)} "
          f"{' '.join(native.LDLIBS)}: {lib.name} {'built' if built else 'found'} in "
          f"{time.perf_counter() - t0:.2f} s; numpy {np.__version__}", flush=True)
    check("PMVS_NO_NATIVE" not in os.environ, "dataplane: PMVS_NO_NATIVE is set")
    io.reset_native()

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
            np.ascontiguousarray(a).view(np.uint32), np.ascontiguousarray(b).view(np.uint32))

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "dtu_wde3.yaml"))
    t = cfg.DATA.TRAIN
    h, w, views = 512, 640, 5
    work = tempfile.mkdtemp(prefix="chip_smoke_dataplane_")
    try:
        t0 = time.perf_counter()
        make_synthetic_dtu(os.path.join(work, "dtu"), scans=[2], num_views=views, height=h,
                           width=w, num_depth=t.NUM_VIRTUAL_PLANE)
        t_tree = time.perf_counter() - t0
        cams = sorted(glob.glob(os.path.join(work, "dtu", "Cameras", "*_cam.txt")))
        depths = sorted(glob.glob(os.path.join(work, "dtu", "Depths", "*", "*.pfm")))
        rng = np.random.RandomState(0)
        extra = []
        for i, (shape, scale) in enumerate([((h, w, 3), 1.0), ((h, w), 2.5), ((h, w, 3), 0.37),
                                            ((37, 53), 2.5)]):
            extra.append(os.path.join(work, f"extra{i}.pfm"))
            io.write_pfm(extra[-1], rng.randn(*shape).astype(np.float32) * 100, scale=scale)
        for p in depths + extra:
            check(same(io.load_pfm(p), io._load_pfm_py(p)), f"dataplane: {p}: C != Python")
        for p in cams:
            for kw in ({}, dict(interval_scale=t.INTERVAL_SCALE, num_depth=t.NUM_VIRTUAL_PLANE)):
                check(same(io.load_cam(p, **kw), io._load_cam_py(p, **kw)),
                      f"dataplane: {p} {kw}: C != Python")
        sweep = []
        for i in range(2000):
            sweep.append(os.path.join(work, f"sweep{i:04d}_cam.txt"))
            with open(sweep[-1], "w") as f:
                f.write(sweep_cam_text(rng))
        twice = 0
        for p in sweep:
            for scale in (1.0, 1.06, 0.8):
                for nd in (None, 0, 48, 96, 192):
                    c, py = io.load_cam(p, scale, nd), io._load_cam_py(p, scale, nd)
                    check(same(c, py), f"dataplane: sweep {p} x{scale} D={nd}: C != Python")
                    twice += bool(nd) and c[1, 3, 3] != np.float32(c[1, 3, 0]) + np.float32(
                        nd - 1) * np.float32(c[1, 3, 1])
        print(f"dataplane: C path bit-equal to the Python readers on this host: {len(depths)} "
              f"depth maps and {len(cams)} cams of a {w}x{h} train tree (D="
              f"{t.NUM_VIRTUAL_PLANE}, x{t.INTERVAL_SCALE}; written in {t_tree:.1f} s), "
              f"{len(extra)} PFMs of 3 channels or scale 2.5 / 0.37, 2000 seeded cam files x "
              f"3 interval scales x 5 counts ({twice} reads where float32 arithmetic would "
              f"round depth_max otherwise)", flush=True)

        def read_bytes(path):
            with open(path, "rb") as f:
                return f.read()

        depth, cam = depths[0], cams[0]
        times = {"load_pfm": (host_ms(lambda: native.load_pfm(depth), 50),
                              host_ms(lambda: io._load_pfm_py(depth), 50),
                              host_ms(lambda: read_bytes(depth), 50)),
                 "load_cam": (host_ms(lambda: native.load_cam(cam, 1.06, 48), 200),
                              host_ms(lambda: io._load_cam_py(cam, 1.06, 48), 200),
                              host_ms(lambda: read_bytes(cam), 200))}
        batch = []
        for i in range(49):
            batch.append(os.path.join(work, f"batch{i:02d}.pfm"))
            io.write_pfm(batch[-1], rng.rand(h, w).astype(np.float32) * 1000)
        stacked = np.stack([io._load_pfm_py(p) for p in batch])
        for n_threads in (1, 0):
            check(same(native.load_pfm_batch(batch, h, w, n_threads=n_threads), stacked),
                  f"dataplane: load_pfm_batch n_threads={n_threads} != Python")
        batch_ms = {n: host_ms(lambda: native.load_pfm_batch(batch, h, w, n_threads=n), 10)
                    for n in (1, 0)}
        batch_py = host_ms(lambda: [io._load_pfm_py(p) for p in batch], 5)
        print(f"dataplane: host ms, C path / Python / the file's bytes read in Python "
              f"(mean): load_pfm {w}x{h} " + " / ".join(f"{v:.4f}" for v in times["load_pfm"])
              + f" ({times['load_pfm'][1] / times['load_pfm'][0]:.2f}x), load_cam "
              + " / ".join(f"{v:.4f}" for v in times["load_cam"])
              + f" ({times['load_cam'][1] / times['load_cam'][0]:.2f}x); load_pfm_batch of 49 "
              f"maps 1 thread {batch_ms[1]:.3f}, {os.cpu_count()} threads {batch_ms[0]:.3f} "
              f"({batch_ms[1] / batch_ms[0]:.2f}x), Python loop {batch_py:.3f}; "
              f"{smi_line()}", flush=True)

        pngs = sorted(glob.glob(os.path.join(work, "dtu", "Rectified", "*", "*.png")))
        phase_dataplane_images(work, pngs[0])

        cfg.DATA.TRAIN.ROOT_DIR = os.path.join(work, "dtu")
        rates = {}
        for workers in (1, 4):
            cfg.DATA.NUM_WORKERS = workers
            for native_on in (True, False, False, True):
                r, n, read = loader_items_per_s(cfg, native_on)
                check(bool(read["cam"]) == native_on and bool(read["png"]) == native_on,
                      f"dataplane: loader with C path {native_on} read {read} in C")
                rates.setdefault((workers, native_on), []).append(r)
        print(f"dataplane: DTU train loader (configs/dtu_wde3.yaml, {w}x{h}, V={t.NUM_VIEW}, "
              f"B={cfg.TRAIN.BATCH_SIZE}, {n} items per epoch, PNGs with Up rows) items/s, C "
              f"path / PMVS_NO_NATIVE=1, two epochs each: "
              + "; ".join(f"NUM_WORKERS {wk} {[round(r, 2) for r in rates[(wk, True)]]} / "
                          f"{[round(r, 2) for r in rates[(wk, False)]]}" for wk in (1, 4))
              + f"; {smi_line()}", flush=True)

        # the same tree with Paeth rows, as libpng's adaptive filters choose
        # them often (the Python unfilter walks such rows along diagonals)
        paeth = os.path.join(work, "dtu_paeth")
        shutil.copytree(os.path.join(work, "dtu"), paeth)
        t0 = time.perf_counter()
        for p in glob.glob(os.path.join(paeth, "Rectified", "*", "*.png")):
            io.write_png(p, io.read_png(p), filters=4)
        t_paeth = time.perf_counter() - t0
        cfg.DATA.TRAIN.ROOT_DIR = paeth
        cfg.DATA.NUM_WORKERS = 1
        rates = {}
        for native_on in (True, False, True):
            r, n, read = loader_items_per_s(cfg, native_on)
            check(bool(read["png"]) == native_on,
                  f"dataplane: Paeth loader with C path {native_on} read {read} in C")
            rates.setdefault(native_on, []).append(r)
        print(f"dataplane: DTU train loader on the tree rewritten with Paeth rows (in "
              f"{t_paeth:.1f} s), NUM_WORKERS 1, items/s C path "
              f"{[round(r, 2) for r in rates[True]]} / PMVS_NO_NATIVE=1 "
              f"{[round(r, 2) for r in rates[False]]}; {smi_line()}",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# (G, k, window) of the general kNN's checks: the Pallas kernel's own tests'
# shapes, MODEL.KNN 8, FLOW_INTERVAL_M 3 (G = 7) and G = 14 (the most levels
# window 3 holds) at window 3, the corner bound k = G·(win/2+1)² at window
# 5, the widest window, and window 1 at G = 128 (the masked max's widest
# staging plan: one tile row; k = 128 the longest list)
ENV_KNN = [(3, 6, 3), (5, 12, 5), (5, 8, 5), (7, 8, 3), (14, 16, 3), (5, 45, 5), (1, 36, 11),
           (128, 8, 1), (128, 128, 1)]
# the masked max past 65535 channel chunks of any staging plan: G = 1,
# window 3, a 3x5 grid, F = 2^21 + 8 bf16 (63 MB)
ENV_WIDE = (1, 3, 3, 5, 2 ** 21 + 8)
ENV_F = (10, 32, 64, 160)
ENV_GRIDS = [(37, 53), FLOWS[0]]     # no multiple of either kernel's tile; flow1
ENV_K = 8                            # MODEL.KNN of the timed shapes and the requests
# MODEL.<key> of the card-vs-CPU parity cases
ENV_PARITY = [{"KNN": 8}, {"KNN": 8, "KNN_WINDOW": 3}, {"FLOW_INTERVAL_M": 3, "KNN_WINDOW": 3}]
ENV_BAND_CR = 64                     # FLOW_CHUNK_ROWS of the banded train step at 640x512
# the tuned kNN's and the masked max's per-request device time (k = 16) and
# the unbanded f32 train step as PERF.md records them (NVIDIA H100 80GB
# HBM3, 700 W)
RECORDED_REQUEST_MS = {"window_knn": 0.4184, "masked_window_max": 1.09635}
UNBANDED_STEP = "779.0-807.6 ms, 46.88 GiB"


def reset_launches() -> None:
    from pointmvsnet_tpu_torch.ops import edge, knn
    knn.launches = edge.launches = 0
    knn.launches_by.update(tuned=0, general=0)


def launch_counts() -> dict:
    """Launches since ``reset_launches``: the tuned kNN ("window_knn"), the
    general kNN and the masked max."""
    from pointmvsnet_tpu_torch.ops import edge, knn
    return {"window_knn": knn.launches_by["tuned"],
            "window_knn_general": knn.launches_by["general"],
            "masked_window_max": edge.launches}


class forbid_plain_on_cuda:
    """Inside the block a plain kNN or masked max given a CUDA tensor
    fails the run: on the card the model's path runs the kernels."""

    def __enter__(self):
        from pointmvsnet_tpu_torch.ops import edge, knn
        self.saved = [(knn, "window_knn", knn.window_knn),
                      (edge, "masked_window_max_plain", edge.masked_window_max_plain)]
        for mod, attr, fn in self.saved:
            setattr(mod, attr, self._guard(attr, fn))

    @staticmethod
    def _guard(attr, fn):
        def call(t, *args, **kwargs):
            check(not t.is_cuda, f"the plain {attr} ran on a CUDA tensor on the model's path")
            return fn(t, *args, **kwargs)
        return call

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def envelope_kernels(dev) -> dict:
    """The general kNN and the masked max against their plain versions,
    bit for bit, on the card and (small grids) on the CPU: the kNN at every
    ENV_KNN shape (and forced at the tuned kernel's (5, 16, 5)) on
    ENV_GRIDS and ``point_cases``; the masked max at every (G, window) of
    those, F ENV_F, bf16 and f32, NaN rows and {-0, +0, ±1}, kNN and random
    masks, and at ENV_WIDE. →
    {"window_knn": max |Δidx|, "masked_window_max": max |Δ| off NaN}."""
    from pointmvsnet_tpu_torch.ops import edge, knn

    err = {"window_knn": 0.0, "masked_window_max": 0.0}
    masks, n_knn, n_mwm = {}, 0, 0
    for g, k, win in ENV_KNN + [(5, 16, 5)]:
        for small, (h, w) in zip((True, False), ENV_GRIDS):
            grid, b = (g, h, w), 2 if small else 1
            rng = np.random.RandomState(g * 1000 + k * 10 + win)
            for case, arr in point_cases(rng, b, g, h, w).items():
                pts = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)
                before = knn.launches_by["general"]
                idx, mask = knn.window_knn_cuda(pts, grid, k, win, variant="general")
                torch.cuda.synchronize()
                check(knn.launches_by["general"] == before + 1, "the general kNN did not count")
                ref = knn.window_knn(pts, grid, k, win, with_mask=True)
                ok = torch.equal(idx, ref[0]) and torch.equal(mask, ref[1])
                if small:
                    cpu = knn.window_knn(pts.cpu(), grid, k, win, with_mask=True)
                    ok = ok and torch.equal(idx.cpu(), cpu[0]) and torch.equal(mask.cpu(), cpu[1])
                check(ok, f"envelope: general window_knn G={g} k={k} win={win} {case} grid "
                          f"{grid}: kernel != plain")
                err["window_knn"] = max(err["window_knn"],
                                        float((idx.long() - ref[0].long()).abs().max()))
                n_knn += 1
                if small and case == "random":
                    masks.setdefault((g, win), mask)
    h, w = ENV_GRIDS[0]
    for (g, win), kmask in masks.items():
        grid, p, b = (g, h, w), g * h * w, 2
        for mcase, m in (("knn", kmask), ("random", random_mask(b, g, h, w, dev, g + win, win))):
            for f in ENV_F:
                for kind in ("nan", "zeros"):
                    z32 = torch.from_numpy(special_z(kind, b, p, f, g * 100 + f)).to(dev)
                    for dtype in (torch.bfloat16, torch.float32):
                        z = z32.to(dtype)
                        ref = edge.masked_window_max_plain(z, m, grid, win)
                        cpu = (edge.masked_window_max_plain(z.cpu(), m.cpu(), grid, win)
                               if f == 10 and mcase == "knn" else ref.cpu())
                        out = edge.masked_window_max_cuda(z, m, grid, win)
                        torch.cuda.synchronize()
                        check(same_bits(out, ref) and same_bits(out.cpu(), cpu),
                              f"envelope: masked_window_max {kind} {mcase}-mask grid {grid} "
                              f"win={win} F={f} {dtype}: kernel != plain")
                        d = (out.float() - ref.float()).abs()
                        err["masked_window_max"] = max(err["masked_window_max"],
                                                       float(d[~torch.isnan(d)].max()))
                        n_mwm += 1
                        if kind == "nan":
                            check(bool(torch.isnan(ref).any()), "no NaN reached the output")
                        elif mcase == "knn":
                            zero = ref[ref == 0]
                            check(bool(torch.signbit(zero).any())
                                  and bool((~torch.signbit(zero)).any()),
                                  f"the ±0 case at G={g} win={win} produced only one zero")
    # past 65535 blocks of channel chunks
    g, win, h, w, f = ENV_WIDE
    grid, plan = (g, h, w), edge.staging_plan(g, win, f, torch.bfloat16)
    check(-(-f * 2 // plan.chunk_bytes) > 65535, f"envelope: F={f} fits 65535 chunks")
    pts = torch.from_numpy(np.random.RandomState(5).rand(1, g * h * w, 3).astype(np.float32))
    kmask = knn.window_knn_cuda(pts.to(dev), grid, 4, win)[1]
    for mcase, m in (("knn", kmask), ("random", random_mask(1, g, h, w, dev, 5, win))):
        for kind in ("nan", "zeros"):
            z = torch.from_numpy(special_z(kind, 1, g * h * w, f, 5)).to(dev).bfloat16()
            out = edge.masked_window_max_cuda(z, m, grid, win)
            torch.cuda.synchronize()
            check(same_bits(out, edge.masked_window_max_plain(z, m, grid, win)),
                  f"envelope: masked_window_max {kind} {mcase}-mask grid {grid} "
                  f"win={win} F={f} bf16: kernel != plain")
            n_mwm += 1
            del z, out
    print(f"envelope: general window_knn bit-equal to the plain version in {n_knn} cases "
          f"((G, k, win) {ENV_KNN} and (5, 16, 5) forced; grids {ENV_GRIDS}; random, integer "
          f"lattice, duplicated levels; the {ENV_GRIDS[0]} grid against the CPU too); "
          f"masked_window_max in {n_mwm} cases (every (G, win) {sorted(masks)}; F {ENV_F}; "
          f"NaN rows, {{-0, +0, ±1}}; kNN and random "
          f"masks; bf16, f32; F=10 against the CPU too; and G={g} win={win} grid {grid} "
          f"F={f} bf16, {-(-f * 2 // plan.chunk_bytes)} chunks of {plan.chunk_bytes} B)",
          flush=True)
    return err


def envelope_timing(dev) -> dict:
    """Device time (CUPTI) of the general kNN and the masked max at the
    paper-eval flow grids with k = ENV_K, window 5 and 3
    ("masked_window_max_knn8"), beside the plain versions and the bound;
    the tuned kNN's and the masked max's per-request time at k = 16 beside
    the recorded one, and the general kNN forced on the tuned kNN's inputs
    (k = 16, window 5: "window_knn_general_at_tuned"), bit-equal to it. →
    {(kernel, window): [ms, plain_ms, bound_ms] per request, with the
    bound's kind and the time's source}."""
    from pointmvsnet_tpu_torch.ops import edge, knn

    per: dict = {}

    def add(key, n, ms, pms, bb, by, how):
        t = per.setdefault(key, [0.0, 0.0, 0.0, set(), set()])
        t[0] += n * ms; t[1] += n * pms; t[2] += n * bb; t[3].add(by); t[4].add(how)

    for fi, (h, w) in enumerate(FLOWS, 1):
        grid = (G, h, w)
        pts = flow_points(h, w, dev)
        gen = torch.Generator(device=dev).manual_seed(fi)
        zs = {f: torch.randn(1, G * h * w, f, device=dev, generator=gen).bfloat16()
              for f in sorted(set(EDGE_F))}
        idx16, mask16 = knn.window_knn_cuda(pts, grid)
        ms, how = cupti_ms(lambda: knn.window_knn_cuda(pts, grid), "window_knn_kernel")
        add(("window_knn", 5), 1, ms, 0.0, 0.0, "bytes", how)
        # the general kNN forced at the tuned kNN's shape, same inputs
        forced = knn.window_knn_cuda(pts, grid, variant="general")
        torch.cuda.synchronize()
        check(torch.equal(forced[0], idx16) and torch.equal(forced[1], mask16),
              f"envelope: general window_knn forced at flow{fi} k=16 win=5 != tuned")
        ms, how = cupti_ms(lambda: knn.window_knn_cuda(pts, grid, variant="general"),
                           "window_knn_general_kernel")
        add(("window_knn_general_at_tuned", 5), 1, ms, 0.0, *bound_ms(*knn_bound(h, w)), how)
        for f, z in zs.items():
            ms, how = cupti_ms(lambda: edge.masked_window_max_cuda(z, mask16, grid),
                               "masked_window_max_kernel")
            add(("masked_window_max", 5), EDGE_F.count(f), ms, 0.0,
                *bound_ms(*mwm_bound(z, mask16)), how)
        for win in (5, 3):
            idx, mask = knn.window_knn_cuda(pts, grid, ENV_K, win)
            torch.cuda.synchronize()
            ref = knn.window_knn(pts, grid, ENV_K, win, with_mask=True)
            check(torch.equal(idx, ref[0]) and torch.equal(mask, ref[1]),
                  f"envelope: window_knn flow{fi} k={ENV_K} win={win}: kernel != plain")
            ms, how = cupti_ms(lambda: knn.window_knn_cuda(pts, grid, ENV_K, win),
                               "window_knn_general_kernel")
            pms = time_ms(lambda: knn.window_knn(pts, grid, ENV_K, win, with_mask=True),
                          reps=3, warmup=1)
            bb, by = bound_ms(*knn_bound(h, w, G, ENV_K, win))
            add(("window_knn_general", win), 1, ms, pms, bb, by, how)
            line = [f"window_knn_general {ms:.4f} ms ({how}), plain {pms:.3f}, bound {bb:.4f} "
                    f"({by})"]
            for f, z in zs.items():
                out = edge.masked_window_max_cuda(z, mask, grid, win)
                torch.cuda.synchronize()
                check(same_bits(out, edge.masked_window_max_plain(z, mask, grid, win)),
                      f"envelope: masked_window_max flow{fi} win={win} F={f}: kernel != plain")
                ms, how = cupti_ms(lambda: edge.masked_window_max_cuda(z, mask, grid, win),
                                   "masked_window_max_kernel")
                pms = time_ms(lambda: edge.masked_window_max_plain(z, mask, grid, win),
                              reps=3, warmup=1)
                bb, by = bound_ms(*mwm_bound(z, mask))
                add(("masked_window_max_knn8", win), EDGE_F.count(f), ms, pms, bb, by, how)
                line.append(f"masked_window_max F={f} bf16 {ms:.4f} ms ({how}), plain "
                            f"{pms:.3f}, bound {bb:.4f} ({by})")
            print(f"envelope: flow{fi} grid {grid} k={ENV_K} win={win}: {'; '.join(line)}",
                  flush=True)
    for (name, win), t in sorted(per.items()):
        if name in RECORDED_REQUEST_MS:
            base = f" (recorded: {RECORDED_REQUEST_MS[name]} ms; k=16)"
        elif name.endswith("_at_tuned"):
            base = (f" (forced at k=16 win=5; the tuned kernel on the same inputs "
                    f"{per[('window_knn', 5)][0]:.5f} ms), bound {t[2]:.5f} ms")
        else:
            base = f", plain {t[1]:.1f} ms, bound {t[2]:.5f} ms ({'+'.join(sorted(t[3]))})"
        print(f"envelope: per paper-eval request (flow1-3, F=(32,32,64) bf16) {name} win={win}: "
              f"{t[0]:.5f} ms ({'+'.join(sorted(t[4]))}){base}; {smi_line()}", flush=True)
    return per


def envelope_requests() -> dict:
    """Paper-eval requests (640x512, V=5, D=96, bf16) at MODEL.KNN 8,
    window 5 and window 3: 3 kNN launches (general) and 9 masked-max
    launches per request, no plain version on a CUDA tensor, finite maps;
    latency, host clock. → {window: launches by kernel}."""
    import gc

    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.predictor import Predictor

    res = {}
    for win in (5, 3):
        cfg = with_model(get_default_cfg(), {"DTYPE": "bfloat16", "KNN": ENV_K,
                                             "KNN_WINDOW": win})
        h, w = cfg.DATA.TEST.IMG_HEIGHT, cfg.DATA.TEST.IMG_WIDTH
        v, d = cfg.DATA.TEST.NUM_VIEW, cfg.DATA.TEST.NUM_VIRTUAL_PLANE
        images, cams, _ = make_scene_batch(1, v, h, w, d, seed=0)
        pred = Predictor(cfg, device="cuda")
        pred(images[0], cams[0])
        lat = []
        want = {"window_knn": 0, "window_knn_general": 3, "masked_window_max": 9}
        for r in range(2):
            reset_launches()
            with forbid_plain_on_cuda():
                t0 = time.perf_counter()
                out = pred(images[0], cams[0])
                lat.append((time.perf_counter() - t0) * 1e3)
            got = launch_counts()
            check(got == want, f"envelope: KNN {ENV_K} win {win} request {r}: launches {got}, "
                               f"want {want}")
            check(out["depth"].shape == (h, w) and all(np.isfinite(a).all() for a in out.values()),
                  f"envelope: KNN {ENV_K} win {win} request {r}: bad or non-finite maps")
        res[win] = got
        print(f"envelope: paper-eval request {w}x{h} V={v} D={d} bf16 MODEL.KNN {ENV_K} "
              f"KNN_WINDOW {win}: launches {got}, no plain version on a CUDA tensor, finite "
              f"maps; latency ms {[round(t, 1) for t in lat]} (host clock); {smi_line()}",
              flush=True)
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    return res


def envelope_banded_train(dev, per_train=None) -> dict:
    """train() at the reference config (640x512, V=3, D=48, B=4, f32) with
    FLOW_CHUNK_ROWS ENV_BAND_CR for 2 coarse-only and 2 flow steps with
    their validation (as the train phase, so that the masked flow losses
    see pixels), then 3 timed flow steps: 2 + 4 bands, so 6 kNN launches
    per step and none of the masked max; finite losses and parameters;
    step time and peak memory beside the unbanded step's."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.build import build_data_loader
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
    from pointmvsnet_tpu_torch.models import build_loss_fn
    from pointmvsnet_tpu_torch.parallel import make_train_step, put_batch
    from pointmvsnet_tpu_torch.train import train

    work = tempfile.mkdtemp(prefix="chip_smoke_band_")
    try:
        cfg = with_model(get_default_cfg(), {"FLOW_CHUNK_ROWS": ENV_BAND_CR})
        h, w, d = 512, 640, cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE
        make_synthetic_dtu(os.path.join(work, "dtu"), scans=[2, 3, 5], num_views=3, height=h,
                           width=w, num_depth=d)
        for split in ("TRAIN", "VAL"):
            cfg.DATA[split].ROOT_DIR = os.path.join(work, "dtu")
        cfg.SCHEDULER.INIT_EPOCH = 1
        cfg.SCHEDULER.MAX_EPOCH = 2
        bands = [n_bands(int(h * s), ENV_BAND_CR) for s in cfg.MODEL.TRAIN.IMG_SCALES]
        n_knn, n_edge = sum(bands), len(cfg.MODEL.EDGE_CHANNELS) * sum(bands)
        reset_launches()
        state = train(cfg, os.path.join(work, "out"), max_steps_per_epoch=2, device="cuda")
        torch.cuda.synchronize()
        got = launch_counts()
        # 2 flow steps and 1 flow validation batch, banded alike
        want = {"window_knn": 3 * n_knn, "window_knn_general": 0, "masked_window_max": n_edge}
        check(state.step == 4 and state.optimizer.skipped_steps == 0 and got == want,
              f"envelope banded train(): step {state.step}, skipped "
              f"{state.optimizer.skipped_steps}, launches {got}, want {want}")
        kw = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
                  inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES),
                  num_virtual_plane=cfg.MODEL.NUM_VIRTUAL_PLANE)
        step = make_train_step(build_loss_fn(cfg), kw)
        batch = put_batch(next(iter(build_data_loader(cfg, "train"))), torch.device("cuda"))
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            reset_launches()
            t0 = time.perf_counter()
            state, losses = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = launch_counts()
            check(got == {"window_knn": n_knn, "window_knn_general": 0, "masked_window_max": 0},
                  f"envelope banded step: launches {got}, want {n_knn} kNN")
            check(all(np.isfinite(float(v)) for v in losses.values()), f"losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(state.optimizer.skipped_steps == 0
              and all(torch.isfinite(p).all() for p in state.model.parameters()),
              "envelope banded step: skipped a step or non-finite parameters")
        unbanded = (f"this run's unbanded step ms {[round(t, 1) for t in per_train['step_ms']]}, "
                    f"{per_train['peak_gib']:.2f} GiB; " if per_train else "")
        print(f"envelope: banded train step {w}x{h} V=3 D={d} B={cfg.TRAIN.BATCH_SIZE} f32 "
              f"FLOW_CHUNK_ROWS {ENV_BAND_CR} ({'+'.join(map(str, bands))} bands): kNN launches "
              f"per step {n_knn}, masked-max 0; step ms {[round(t, 1) for t in times]}, "
              f"max_memory_allocated {peak:.2f} GiB; {unbanded}unbanded as recorded: "
              f"{UNBANDED_STEP}; losses "
              f"{ {k: round(float(v), 4) for k, v in losses.items() if k.endswith('loss')} }; "
              f"{smi_line()}", flush=True)
        return dict(launches=n_knn, step_ms=times, peak_gib=peak)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_envelope(dev, per_train=None) -> dict:
    """The kernels over the Pallas kernels' whole envelope, and banded
    PointFlow in training (see the module docstring). → the numbers of the
    general kNN's row and of the masked max's KNN 8 keys of the kernels
    line."""
    t0 = time.perf_counter()
    err = envelope_kernels(dev)
    timing = envelope_timing(dev)
    requests = envelope_requests()
    for overrides in ENV_PARITY:
        phase_parity(overrides, "envelope parity")
        phase_train_parity(overrides, 2, "envelope train-parity")
    phase_train_parity({"FLOW_CHUNK_ROWS": 8}, 1 + 4, "envelope banded train-parity")
    banded = envelope_banded_train(dev, per_train)
    print(f"envelope: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(err=err, timing=timing, requests=requests, banded=banded)


# ------------------------------------------------------------ tanks

# the sweep's tokens: the JAX tool's four defaults, then unbanded 1280x1024 (the
# port's FLOW_CHUNK_ROWS -1) and T&T's 1920x1080 frame after the base-64 crop
TT_EXTRA_TOKENS = ["bilinear:0@1280x1024", "bilinear:0@1920x1024"]
TT_GRIDS = [(1024, 1280), (1024, 1920)]     # (H, W) of the kernels' T&T requests
TT_BANDS = (0, 64, 32, 128)                 # FLOW_CHUNK_ROWS held bit-equal at TT_GRIDS[0]
TT_SHAPE_SET = ((1024, 1920), (1024, 1280))
# scene → (height, width, cam num_depth) of its frames, and the member of
# TT_SHAPE_SET that pick_shape gives it: Family as the real release's
# (1920x1080, 256 depths), Horse at a ragged width
TT_SCENES = {"Family": ((1080, 1920, 256), TT_SHAPE_SET[0]),
             "Horse": ((1080, 1280, 96), TT_SHAPE_SET[1])}
TT_VIEWS = 6


def tanks_want(h: int, cr: int) -> dict:
    """Launches of one T&T map at input height ``h`` and FLOW_CHUNK_ROWS
    ``cr``: a kNN (tuned) per flow band, a masked max per band and
    EdgeConv."""
    bands = sum(n_bands(int(h * s), cr) for s in (0.25, 0.5, 1.0))
    return {"window_knn": bands, "window_knn_general": 0,
            "masked_window_max": len(EDGE_F) * bands}


def tanks_sweep(dev, work: str) -> dict:
    """``benchmarks/tt_sweep.py``'s main on its default tokens and
    TT_EXTRA_TOKENS, out file in ``work``: no token may record an error;
    each token's launches per map (its 3 · 6 forwards) by kernel, no
    plain version on a CUDA tensor. → {token: record}."""
    from pointmvsnet_tpu_torch.benchmarks import tt_sweep

    tokens = tt_sweep.DEFAULT_TOKENS + TT_EXTRA_TOKENS
    counted = []
    real = tt_sweep.measure

    def measure(model, images, cams, kwargs, iters):
        reset_launches()
        res = real(model, images, cams, kwargs, iters=iters)
        counted.append({n: c // (3 * iters) for n, c in launch_counts().items()})
        check(all(c % (3 * iters) == 0 for c in launch_counts().values()),
              f"tanks sweep: launches {launch_counts()} over {3 * iters} forwards")
        return res

    t0 = time.perf_counter()
    tt_sweep.measure = measure
    try:
        with forbid_plain_on_cuda():
            res = tt_sweep.main(tokens + ["--out", os.path.join(work, "tt_sweep_torch.json"),
                                          "--device", str(dev)])
    finally:
        tt_sweep.measure = real
    check(len(counted) == len(tokens), f"tanks sweep: {len(counted)} tokens measured")
    for tok, got in zip(tokens, counted):
        rec = res[tok]
        check("error" not in rec and "maps_per_sec" in rec, f"tanks sweep {tok}: {rec}")
        _, cr, _, h = tt_sweep.parse_token(tok)
        want = tanks_want(h, cr)
        check(got == want, f"tanks sweep {tok}: launches per map {got}, want {want}")
        print(f"tanks: sweep {tok}: {json.dumps(rec)}; launches per map kNN "
              f"{got['window_knn']} (tuned) masked-max {got['masked_window_max']}; "
              f"{smi_line()}", flush=True)
    print(f"tanks: sweep of {len(tokens)} tokens in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {tok: dict(res[tok], launches=got) for tok, got in zip(tokens, counted)}


def tanks_kernels(dev) -> tuple:
    """The paper-eval forward (bench.build, tt_sweep's KWARGS, weights
    seed 0) at each of TT_GRIDS unbanded, and at TT_GRIDS[0] at every
    FLOW_CHUNK_ROWS of TT_BANDS: launches per map by kernel, no plain
    version on a CUDA tensor, every banded map bit-equal to the unbanded
    one; at each grid unbanded, every kernel call bit-equal to its plain
    version on its real inputs (NaN positions and the sign of zero
    included) and timed (CUPTI) beside the plain version and the bound.
    Also the launches of PointFlow's fused fetch, one a flow band. →
    ({"WxH": {name: (ms, plain_ms, bound_ms, source) per map}}, {"WxH":
    fused fetch launches of the unbanded map})."""
    import gc

    from pointmvsnet_tpu_torch.bench import build, make_inputs
    from pointmvsnet_tpu_torch.benchmarks.tt_sweep import KWARGS, VIEWS
    from pointmvsnet_tpu_torch.ops import sampling
    from pointmvsnet_tpu_torch.utils.convert import init_params

    weights, per_grid, fetch_launches = None, {}, {}
    for (h, w), chunks in zip(TT_GRIDS, (TT_BANDS, (0,))):
        images, cams = make_inputs(1, VIEWS, h, w, KWARGS["num_virtual_plane"], device=dev)
        maps = {}
        for cr in chunks:
            _, model = build(chunk_rows=cr, device=dev)
            if weights is None:
                weights = init_params(model, torch.Generator().manual_seed(0))
            model.load_state_dict(weights)
            reset_launches()
            sampling.launches = 0
            with torch.inference_mode(), forbid_plain_on_cuda(), \
                    (record_kernel_calls() if cr == 0 else contextlib.nullcontext()) as calls:
                t0 = time.perf_counter()
                out = model(images, cams, **KWARGS)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            got, want = launch_counts(), tanks_want(h, cr)
            check(got == want, f"tanks {w}x{h} FLOW_CHUNK_ROWS={cr}: launches {got}, want {want}")
            n_fetch = sampling.launches
            check(n_fetch == want["window_knn"],
                  f"tanks {w}x{h} FLOW_CHUNK_ROWS={cr}: {n_fetch} point-fetch launches, want "
                  f"{want['window_knn']} (one a flow band)")
            if cr == 0:
                fetch_launches[f"{w}x{h}"] = n_fetch
            check(all(bool(torch.isfinite(out[k]).all()) for k in ("coarse_depth_map", "flow3")),
                  f"tanks {w}x{h} FLOW_CHUNK_ROWS={cr}: non-finite maps")
            maps[cr] = {k: v for k, v in out.items() if not k.endswith("_input")}
            note = ""
            if cr == 0:
                met = check_kernel_calls(calls, f"tanks {w}x{h}")
                shapes: dict = {}
                per_grid[f"{w}x{h}"] = totals = time_kernel_calls(calls, shapes)
                for (name, grid, f, dt), (kms, pms, bb, by, how) in sorted(shapes.items()):
                    print(f"tanks: {name} at {w}x{h} grid {grid} F={f} {dt}: kernel {kms:.4f} ms "
                          f"({how}), plain {pms:.3f} ms, bound {bb:.4f} ms ({by})", flush=True)
                note = (f"; kernel calls bit-equal to their plain versions ({met}); per map "
                        f"kernel / plain / bound ms " + ", ".join(
                            f"{k} {t[0]:.5f} ({t[3]}) / {t[1]:.1f} / {t[2]:.5f}"
                            for k, t in totals.items()))
            print(f"tanks: {w}x{h} V={VIEWS} D={KWARGS['num_virtual_plane']} bf16 "
                  f"FLOW_CHUNK_ROWS={cr}: launches per map kNN {got['window_knn']} (tuned) "
                  f"masked-max {got['masked_window_max']}, point-fetch "
                  f"{n_fetch}, first forward "
                  f"{ms:.1f} ms{note}; {smi_line()}", flush=True)
            del model, out, calls
            gc.collect()
            torch.cuda.empty_cache()
        for cr in chunks[1:]:
            same = {k: same_bits(maps[cr][k], a) for k, a in maps[0].items()}
            check(all(same.values()), f"tanks {w}x{h}: FLOW_CHUNK_ROWS={cr} differs from the "
                                      f"unbanded map: {same}")
        if chunks[1:]:
            print(f"tanks: {w}x{h} FLOW_CHUNK_ROWS {chunks[1:]}: every map bit-equal to the "
                  f"unbanded one ({', '.join(maps[0])})", flush=True)
        del images, cams, maps
    return per_grid, fetch_launches


def tanks_export(dev, work: str) -> dict:
    """The test CLI (configs/tanks.yaml, bf16, weights from RNG_SEED,
    SHAPE_SET TT_SHAPE_SET) on a T&T tree of TT_SCENES JPEGs: each scene's
    shape, every file, 3 kNN (tuned) and 9 masked-max launches per map,
    every map's flow3 bit-equal to Predictor's on the same item; maps/s over
    the loop and after each shape's first map, the forward's ms and peak
    memory per shape, the loader's ms per item and the loop's wait for it.
    Then the fuse CLI (torch on ``dev``) on the export, each scene fused
    again for its seconds and peak memory, and one scene on the numpy
    backend against the card (the JAX package's bar). → launches per map."""
    from pointmvsnet_tpu_torch import fuse
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset import io
    from pointmvsnet_tpu_torch.dataset.preprocess import norm_image
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_tanks
    from pointmvsnet_tpu_torch.dataset.tanks import TanksDataset
    from pointmvsnet_tpu_torch.postprocess import read_ply
    from pointmvsnet_tpu_torch.predictor import Predictor

    tree = os.path.join(work, "tanks")
    t0 = time.perf_counter()
    make_synthetic_tanks(tree, scenes=list(TT_SCENES), num_views=TT_VIEWS,
                         per_scene={s: dict(height=h, width=w, num_depth=nd)
                                    for s, ((h, w, nd), _) in TT_SCENES.items()})
    t_tree = time.perf_counter() - t0
    cfg_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "tanks.yaml")
    opts = ["MODEL.DTYPE", "bfloat16", "DATA.TEST.ROOT_DIR", tree,
            "DATA.TEST.SHAPE_SET", str(TT_SHAPE_SET)]
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(opts)
    t = cfg.DATA.TEST
    ds = TanksDataset(tree, num_view=t.NUM_VIEW, num_virtual_plane=t.NUM_VIRTUAL_PLANE,
                      interval_scale=t.INTERVAL_SCALE, rescale_depth=t.RESCALE_DEPTH,
                      shape_set=TT_SHAPE_SET)
    item_ms = {}
    ds[ds.index.index((list(TT_SCENES)[-1], 0))]    # builds the C data plane where it is missing
    for scene in TT_SCENES:
        i = ds.index.index((scene, 1))
        t0 = time.perf_counter()
        ds[i]
        item_ms[scene] = (time.perf_counter() - t0) * 1e3
    # the parts of an item and of a map's files at the largest frame, host ms
    scene = list(TT_SCENES)[0]
    view = ds._image_path(scene, 1)
    img = io.read_image(view)
    shape = TT_SCENES[scene][1]
    parts = {"decode": host_ms(lambda: io.read_image(view), 3),
             "norm_image": host_ms(lambda: norm_image(img.astype(np.float32)), 3),
             "write_png": host_ms(lambda: io.write_png(os.path.join(work, "ref.png"),
                                                       img[:shape[0], :shape[1]]), 3)}
    frames = ", ".join(f"{s} {w}x{h} ({nd} depths)" for s, ((h, w, nd), _) in TT_SCENES.items())
    print(f"tanks: T&T tree {frames}, "
          f"{TT_VIEWS} views each, written in {t_tree:.1f} s; the loader's item ({t.NUM_VIEW} "
          f"JPEG decodes, no cache, scale, crop, standardize) host ms "
          f"{ {s: round(v, 1) for s, v in item_ms.items()} }; {scene}'s parts, host ms (mean "
          f"of 3): {img.shape[1]}x{img.shape[0]} decode {parts['decode']:.1f}, norm_image "
          f"{parts['norm_image']:.1f}, write_png of the {shape[1]}x{shape[0]} reference image "
          f"{parts['write_png']:.1f}", flush=True)

    steps, written = [], []
    real_make, real_log = test_cli.make_eval_step, test_cli.eval_file_logger

    def make_eval_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(state, batch):
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(shape=tuple(batch["images"].shape[2:4]), start=t0,
                              ms=(time.perf_counter() - t0) * 1e3,
                              peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                              launches=launch_counts()))
            return res
        return timed

    def eval_file_logger(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_log(*args, **kwargs)
        written.append((t0, time.perf_counter()))
        return out

    out_dir = os.path.join(work, "tanks_export")
    test_cli.make_eval_step, test_cli.eval_file_logger = make_eval_step, eval_file_logger
    try:
        with forbid_plain_on_cuda():
            t0 = time.perf_counter()
            summary, depth_dir = test_cli.main(["--cfg", cfg_file, "--device", str(dev),
                                                "OUTPUT_DIR", out_dir] + opts)
            t_cli = time.perf_counter() - t0
    finally:
        test_cli.make_eval_step, test_cli.eval_file_logger = real_make, real_log
    n_maps = len(TT_SCENES) * TT_VIEWS
    check(summary["maps"] == n_maps and len(steps) == n_maps == len(written),
          f"tanks export: {summary['maps']} maps, {len(steps)} steps, want {n_maps}")
    want = tanks_want(TT_SHAPE_SET[0][0], 0)
    for s in steps:
        check(s["launches"] == want, f"tanks export: launches {s['launches']}, want {want}")

    pred = Predictor(cfg, device=dev, normalize=False)
    for i, (scene, ref) in enumerate(ds.index):
        scan_dir = os.path.join(depth_dir, f"scan{ds.scenes.index(scene)}")
        stem = os.path.join(scan_dir, f"{ref:08d}")
        names = {os.path.basename(stem) + s for s in ("_init.pfm", "_flow1.pfm", "_flow2.pfm",
                                                      "_flow3.pfm", "_prob.pfm", ".txt", ".png")}
        check(names <= set(os.listdir(scan_dir)), f"tanks export: {scene} view {ref} files")
        flow3 = io.load_pfm(stem + "_flow3.pfm")
        shape = TT_SCENES[scene][1]
        check(flow3.shape == shape and steps[i]["shape"] == shape,
              f"tanks export: {scene} view {ref} map {flow3.shape}, input {steps[i]['shape']}, "
              f"want {shape}")
        item = ds[i]
        served = pred(item["images"], item["cams"])["flow3"]
        check(np.isfinite(flow3).all() and np.array_equal(served, flow3),
              f"tanks export: {scene} view {ref}: flow3 differs from Predictor's, max |Δ| "
              f"{np.abs(served - flow3).max()}")
    del pred

    # a map's period in the loop: the wait for the loader's batch, the
    # forward (eval step, synchronized), the host between them (copies to the
    # host, meters), the writes of its files (eval_file_logger)
    report = []
    for shape in dict.fromkeys(s["shape"] for s in steps):
        idx = [i for i, s in enumerate(steps) if s["shape"] == shape]
        after = (len(idx) - 1) / (written[idx[-1]][1] - written[idx[0]][1])
        ms = {"period": [written[i][1] - written[i - 1][1] for i in idx[1:]],
              "wait": [steps[i]["start"] - written[i - 1][1] for i in idx[1:]],
              "forward": [steps[i]["ms"] / 1e3 for i in idx[1:]],
              "writes": [written[i][1] - written[i][0] for i in idx[1:]]}
        ms = {k: 1e3 * float(np.median(v)) for k, v in ms.items()}
        ms["host"] = ms["period"] - ms["wait"] - ms["forward"] - ms["writes"]
        report.append(f"{shape[1]}x{shape[0]}: {len(idx)} maps, {after:.3f} maps/s after its "
                      f"first map, first forward {steps[idx[0]]['ms']:.1f} ms, then median ms "
                      f"{ {k: round(v, 1) for k, v in ms.items()} }, peak "
                      f"{max(steps[i]['peak'] for i in idx):.2f} GiB")
    print(f"tanks: test CLI (configs/tanks.yaml, bf16, weights from RNG_SEED, SHAPE_SET "
          f"{TT_SHAPE_SET}): {n_maps} maps, {summary['maps_per_s']:.3f} maps/s over the loop, "
          f"{summary['maps_per_s_after_first']:.3f} after the first map, {t_cli:.1f} s with model "
          f"build; {'; '.join(report)}; launches per map kNN {want['window_knn']} (tuned) "
          f"masked-max {want['masked_window_max']}; every flow3 bit-equal to "
          f"Predictor's on the same item; {smi_line()}", flush=True)

    t0 = time.perf_counter()
    res = fuse.main(["--depth_dir", depth_dir, "--out", os.path.join(work, "tanks_clouds"),
                     "--device", str(dev), "--prob_threshold", "0", "--min_views", "2"])
    t_fuse = time.perf_counter() - t0
    scans = sorted(res)
    check(scans == [f"scan{i}" for i in range(len(TT_SCENES))]
          and all(r["backend"] == "torch" and r["n_points"] > 0 for r in res.values()),
          f"tanks fuse: {res}")
    per_scene = []
    for scan in scans:
        scan_dir = os.path.join(depth_dir, scan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pts, _, used = fuse.fuse_scan(scan_dir, prob_threshold=0, min_views=2, device=dev)
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        cli_pts = read_ply(res[scan]["ply"])[0]
        check(used == "torch" and np.array_equal(pts, cli_pts) and np.isfinite(pts).all(),
              f"tanks fuse {scan}: {used}, {len(pts)} points against the CLI's {len(cli_pts)}")
        per_scene.append(f"{scan} {len(pts)} points in {secs:.3f} s, peak {peak:.2f} GiB")
    scan = scans[-1]
    t0 = time.perf_counter()
    npts, _, used = fuse.fuse_scan(os.path.join(depth_dir, scan), prob_threshold=0,
                                   min_views=2, backend="numpy")
    t_np = time.perf_counter() - t0
    c = compare_clouds(read_ply(res[scan]["ply"])[0], npts)
    print(f"tanks: fuse CLI, torch on the card, prob 0, 2 views: {t_fuse:.2f} s for "
          f"{len(scans)} scenes (CLI wall); per scene {'; '.join(per_scene)}; {scan} on the numpy "
          f"backend {t_np:.2f} s, against the card {json.dumps(c)}; {smi_line()}", flush=True)
    check(used == "numpy" and clouds_agree(c), f"tanks fuse {scan}: card against numpy {c}")
    return want


def phase_tanks(dev) -> dict:
    """Tanks & Temples at its own frame sizes (see the module docstring).
    → the numbers of the T&T keys of the kNN's and the masked max's rows."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tanks_")
    try:
        sweep = tanks_sweep(dev, work)
        kernels, fetch_launches = tanks_kernels(dev)
        per_map = tanks_export(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"tanks: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(sweep=sweep, kernels=kernels, per_map=per_map, fetch_launches=fetch_launches)


# ------------------------------------------------------------ bench

# bench.py's line keys and details sections, in its order; the port's
# details add "device" (the card's name and power limit)
BENCH_LINE_KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_source"]
BENCH_DETAILS_KEYS = ["complete", "headline_latency_s", "measured_at", "baseline_source",
                      "device", "stages_s", "V3_D48_fullres", "V5_D96_batch2", "roofline",
                      "train_step"]
BENCH_LAUNCHES = {"window_knn": 3, "window_knn_general": 0, "masked_window_max": 9}


def roofline_span(stage: str) -> str:
    """The stage_latencies entry whose time holds a roofline stage."""
    if stage.startswith("flow3_") or stage == "ref_resample":
        return "flow3_iter_s"
    return "coarse_s" if stage in ("coarse_sweep_warp", "volume_unet") else "total_s"


def phase_bench(dev) -> dict:
    """``python -m pointmvsnet_tpu_torch.bench`` with BENCH_DETAILS set and
    ``--details`` in a temp dir, in a process of its own: exit code 0, the
    first stdout line with exactly bench.py's keys and metric name and a
    finite value above 0, no other line; the details file complete, with
    every section and no error, and nothing else written. Then, in this
    process, one forward on the headline's inputs (``bench.headline``): 3
    kNN (tuned) and 9 masked-max launches, no plain version on a CUDA
    tensor, a finite flow3. Prints the headline, each section's times, the
    train step with its stages, and each roofline row's ceiling beside the
    measured stage that holds it, each with the card's name and power
    limit."""
    import gc
    import math

    from pointmvsnet_tpu_torch import bench

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card = smi_line()
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        path = os.path.join(work, "details.json")
        env = dict(os.environ, BENCH_DETAILS="1", PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pointmvsnet_tpu_torch.bench",
                               "--details", path], cwd=work, env=env, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t1
        for text in proc.stderr.splitlines():
            print(f"bench: stderr: {text}", flush=True)
        check(proc.returncode == 0, f"bench exited {proc.returncode}: {proc.stdout[-1000:]}")
        lines = proc.stdout.splitlines()
        check(len(lines) == 1, f"bench printed {len(lines)} stdout lines, want 1: {lines}")
        line = json.loads(lines[0])
        check(list(line) == BENCH_LINE_KEYS, f"bench line keys {list(line)}")
        check(line["metric"] == bench.METRIC and line["unit"] == bench.UNIT,
              f"bench line {line}")
        check(math.isfinite(line["value"]) and line["value"] > 0, f"bench value {line}")
        check(os.listdir(work) == ["details.json"], f"bench wrote {os.listdir(work)}")
        with open(path) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(list(rec) == BENCH_DETAILS_KEYS, f"bench details keys {list(rec)}")
    check(rec["complete"] is True and '"error"' not in json.dumps(rec),
          f"bench details incomplete or with an error: {json.dumps(rec)[:1000]}")

    _, model, images, cams, kwargs = bench.headline(dev)
    reset_launches()
    with torch.inference_mode(), forbid_plain_on_cuda():
        out = model(images, cams, **kwargs)
        torch.cuda.synchronize()
    got = launch_counts()
    check(got == BENCH_LAUNCHES, f"bench headline forward: launches {got}, "
                                 f"want {BENCH_LAUNCHES}")
    flow3 = out["flow3"]
    check(flow3.shape == images.shape[:1] + images.shape[2:4]
          and bool(torch.isfinite(flow3).all()), f"bench headline flow3 {tuple(flow3.shape)}")
    del model, images, cams, out, flow3
    gc.collect()
    torch.cuda.empty_cache()

    st, tr = rec["stages_s"], rec["train_step"]
    print(f"bench: headline {json.dumps(line)}; {rec['headline_latency_s'] * 1e3:.2f} ms per "
          f"map; launches per map kNN 3 (tuned) masked-max 9, flow3 finite; details device "
          f"{rec['device']}; {card}", flush=True)
    print(f"bench: stages_s " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in st.items())
          + f"; {card}", flush=True)
    v3, b2 = rec["V3_D48_fullres"], rec["V5_D96_batch2"]
    print(f"bench: V3_D48_fullres {v3['maps_per_sec']:.4f} maps/s ({v3['latency_s'] * 1e3:.2f} "
          f"ms); V5_D96_batch2 {b2['maps_per_sec']:.4f} maps/s "
          f"({b2['latency_s_per_batch'] * 1e3:.2f} ms per batch of 2); {card}", flush=True)
    print(f"bench: train_step B={tr['batch_size']} {tr['step_latency_s'] * 1e3:.2f} ms "
          f"({tr['steps_per_sec']:.4f} steps/s, {tr['samples_per_sec']:.4f} samples/s); "
          f"stages " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in tr["stages_s"].items())
          + f"; {card}", flush=True)
    for row in rec["roofline"]:
        span = roofline_span(row["stage"])
        print(f"bench: roofline {row['stage']}: ceiling {row['ceiling_ms']} ms "
              f"({row['bound_by']}; {row['gflops']} GFLOP, {row['stream_mb']} MB, "
              f"{row['gather_rows_m']} M taps) within {span} {st[span] * 1e3:.2f} ms; {card}",
              flush=True)
    flow3_ceiling = sum(r["ceiling_ms"] for r in rec["roofline"]
                        if roofline_span(r["stage"]) == "flow3_iter_s")
    total_ceiling = sum(r["ceiling_ms"] for r in rec["roofline"])
    print(f"bench: roofline sums: flow3 rows {flow3_ceiling:.4f} ms against flow3_iter_s "
          f"{st['flow3_iter_s'] * 1e3:.2f} ms ({100 * flow3_ceiling / (st['flow3_iter_s'] * 1e3):.2f}%); "
          f"all rows {total_ceiling:.4f} ms against total_s {st['total_s'] * 1e3:.2f} ms "
          f"({100 * total_ceiling / (st['total_s'] * 1e3):.2f}%); {card}", flush=True)
    print(f"bench: the bench process {wall:.1f} s, phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(line=line, details=rec, launches=got)


def profile_call(fn, what: str, top: int = 12):
    """One more call of ``fn`` under torch.profiler: device busy time (the
    sum of the GPU kernels and copies), its share of the call's wall time,
    and the operators whose kernels take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    on_gpu = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_gpu) / 1e3
    print(f"profile: {what} under the profiler {wall:.1f} ms wall, device busy "
          f"{busy:.1f} ms ({100 * busy / wall:.1f}%) in {sum(e.count for e in on_gpu)} "
          f"kernels and copies", flush=True)
    ops = sorted((e for e in avgs if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:top]:
        print(f"profile: op {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x {e.key}",
              flush=True)
    for e in sorted(on_gpu, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"profile: gpu {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)


PHASES = ["env", "build", "dataplane", "kernels", "point-fetch", "sweep", "adversarial",
          "gather",
          "parity", "serve", "cascade",
          "train", "train-parity", "export", "export-dtu", "weights", "trained", "fusion-scan",
          "train-bf16", "learn", "train-dp", "parallel-eval", "envelope", "tanks", "bench"]


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="On-card smoke test of the PyTorch / CUDA port")
    p.add_argument("--phases", default="",
                   help="comma-separated subset of dataplane,point-fetch,sweep,parity,cascade,"
                        "train,"
                        "train-bf16,"
                        "learn,train-dp,export-dtu,weights,trained,parallel-eval,envelope,tanks,"
                        "bench to try "
                        "on the card "
                        "(prints no result lines); default: every phase")
    args = p.parse_args(argv)
    phases = ["env", "build"] + args.phases.split(",") if args.phases else PHASES
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pointmvsnet_tpu_torch.ops import _cuda

    import warnings

    from pointmvsnet_tpu_torch import disable_tf32

    card = smi_line()
    # the card by its UUID is the one card that nvidia-smi lists here
    listed = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()
    check("failed" not in card and (len(listed) != 1 or listed == [card]),
          f"env: the card by its UUID gives {card!r}, nvidia-smi lists {listed}")
    found = tf32_flags()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        disable_tf32()                      # counted, then the flags are put back
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = found
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; {card} (by UUID "
          f"{torch.cuda.get_device_properties(0).uuid}; nvidia-smi lists {listed}); TF32 flags as "
          f"found: cudnn.allow_tf32={found[0]} matmul.allow_tf32={found[1]}; "
          f"disable_tf32 warned {len(caught)} time(s) {[str(w.message)[:80] for w in caught]}",
          flush=True)

    t_start = t0 = time.perf_counter()
    _cuda.build()
    print(f"build: {sorted(_cuda.SIGNATURES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    if phases != PHASES:
        # a partial run, to try phases on the card: no result lines
        per_train = phase_train(dev, None) if {"train", "train-bf16"} & set(phases) else None
        for name in phases[2:]:
            if name == "dataplane":
                phase_dataplane()
            elif name == "point-fetch":
                phase_point_fetch(dev)
            elif name == "sweep":
                phase_sweep(dev)
            elif name == "parity":
                phase_parity()
            elif name == "cascade":
                phase_cascade(dev)
            elif name == "train-bf16":
                phase_train_bf16(dev, per_train)
            elif name == "learn":
                phase_learn(dev)
            elif name == "train-dp":
                phase_train_dp(dev)
            elif name == "parallel-eval":
                phase_parallel_eval(dev)
            elif name == "envelope":
                phase_envelope(dev, per_train)
            elif name == "tanks":
                phase_tanks(dev)
            elif name == "bench":
                phase_bench(dev)
            elif name == "trained":
                phase_trained(dev)
            elif name in ("weights", "export-dtu"):
                work = tempfile.mkdtemp(prefix="chip_smoke_partial_")
                try:
                    (phase_weights if name == "weights" else phase_export_dtu)(work)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
            elif name != "train":
                fail(f"--phases: {name} runs only in a whole run")
        print(f"chip_smoke: partial run of {phases}: every check passed")
        return 0
    phase_dataplane()
    tot = phase_kernels(dev)
    fetch, fetch_err = phase_point_fetch(dev)
    sweep, sweep_launches, sweep_err = phase_sweep(dev)
    phase_adversarial(dev)
    gat = phase_gather(dev)
    phase_parity()
    n_knn, n_mwm, n_fetch, n_sweep = phase_serve()
    phase_cascade(dev)
    phase_bench(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        weight = os.path.join(work, "trained.pt")
        per_train = phase_train(dev, weight)
        # before the phases that spawn processes: late in a run CUPTI at
        # times returns no device time (PERF.md), and this phase times kernels
        env = phase_envelope(dev, per_train)
        tanks = phase_tanks(dev)
        phase_edge_conv_backward()
        phase_train_parity()
        per_map = phase_export(weight, work)
        phase_export_dtu(work)
        per_weights = phase_weights(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    per_trained = phase_trained(dev)
    phase_fusion_scan()
    per_bf16 = phase_train_bf16(dev, per_train)
    per_learn = phase_learn(dev)
    phase_train_dp(dev)
    per_band = phase_parallel_eval(dev)

    rows = []
    for name, line, launches in [("window_knn", "knn.py:40", n_knn),
                                 ("masked_window_max", "edge.py:73", n_mwm)]:
        t = tot[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pointmvsnet_tpu_torch/csrc/{name}.cu",
            "replaces": f"pointmvsnet_tpu/ops/pallas/{line}",
            "launches": launches, "max_abs_err": t["err"],
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 4),
            "bound_ms": round(t["bound_ms"], 5),
            "bound_by": "bytes" if t["by"] == {"bytes"} else "operations",
            "library_ms": None,
            "work": "one forward: flow1-3 grids, bf16, F=(32,32,64) per flow",
            "launches_per": "serving request",
            "launches_per_train_step": per_train[name][0],
            "launches_per_val_batch": per_train[name][1],
            "launches_per_exported_map": per_map[0 if name == "window_knn" else 1],
            "launches_per_request_from_converted_weights":
                per_weights[0 if name == "window_knn" else 1],
            "launches_per_map_from_jax_trained_checkpoint":
                per_trained[0 if name == "window_knn" else 1],
            "launches_per_bf16_train_step": per_bf16[name][0],
            "launches_per_bf16_val_batch": per_bf16[name][1],
            "launches_per_learning_flow_step": {
                lab: r["launches"]["train"][name] for lab, r in per_learn.items()},
            "launches_per_learning_eval_step": {
                lab: r["launches"]["eval"][name] for lab, r in per_learn.items()},
            "launches_per_closed_loop_map": {
                lab: r["loop"]["per_map"][name] for lab, r in per_learn.items()},
            "launches_per_banded_request": per_band[name]["launches"],
            "banded_request_flow_chunk_rows": PE_BAND_CR,
            "ms_per_banded_request": round(per_band[name]["ms"], 5),
            "ms_per_banded_request_source": per_band[name]["source"],
            "ms_per_request_envelope_phase": round(env["timing"][(name, 5)][0], 5),
            "launches_per_knn8_request": {w: r[name] for w, r in env["requests"].items()},
            "launches_per_banded_train_step": env["banded"]["launches"] if name == "window_knn"
            else 0,
            "banded_train_flow_chunk_rows": ENV_BAND_CR,
            "launches_per_tanks_map": tanks["per_map"][name],
            **{f"{key}_{grid}": round(t[name][i], 5) for grid, t in tanks["kernels"].items()
               for i, key in enumerate(("ms_per_request", "plain_ms_per_request", "bound_ms"))},
            "ms_per_request_tanks_source": "+".join(sorted(
                {t[name][3] for t in tanks["kernels"].values()})),
            "launches_per_tanks_sweep_map": {tok: r["launches"][name]
                                             for tok, r in tanks["sweep"].items()},
        })
    # the masked max at MODEL.KNN 8: time, plain time and bound per request at
    # the paper-eval flow grids, windows 5 and 3
    rows[1].update({f"{key}_per_knn8_request": {w: round(t[i], 5) for (n, w), t in
                                                 env["timing"].items()
                                                 if n == "masked_window_max_knn8"}
                    for i, key in enumerate(("ms", "plain_ms", "bound_ms"))})
    # the general kNN: launches per KNN 8 request, and time, plain time and
    # bound per such request at the paper-eval flow grids
    ms, pms, bb, by, how = env["timing"][("window_knn_general", 5)]
    rows.append({
        "name": "window_knn_general", "route": "cuda",
        "source": "pointmvsnet_tpu_torch/csrc/window_knn_general.cu",
        "replaces": "pointmvsnet_tpu/ops/pallas/knn.py:40",
        "launches": env["requests"][5]["window_knn_general"],
        "max_abs_err": env["err"]["window_knn"],
        "ms": round(ms, 5), "plain_ms": round(pms, 4), "bound_ms": round(bb, 5),
        "bound_by": "bytes" if by == {"bytes"} else "operations",
        "library_ms": None,
        "work": f"one forward: flow1-3 grids, k={ENV_K}, window 5, bf16, F=(32,32,64) per flow",
        "ms_source": "+".join(sorted(how)),
        "launches_per": f"paper-eval request at MODEL.KNN {ENV_K}, KNN_WINDOW 5",
        "launches_per_knn8_request": {w: r["window_knn_general"]
                                      for w, r in env["requests"].items()},
        "launches_per_banded_train_step": 0,
        "ms_per_request_window": {w: round(t[0], 5) for (n, w), t in env["timing"].items()
                                  if n == "window_knn_general"},
        "ms_forced_at_tuned_shape": round(env["timing"][("window_knn_general_at_tuned", 5)][0],
                                          5),
    })
    rows.append({
        "name": "point_fetch", "route": "cuda",
        "source": "pointmvsnet_tpu_torch/csrc/point_fetch.cu",
        "replaces": "none (the JAX package leaves the fetch to XLA)",
        "launches": n_fetch, "max_abs_err": fetch_err,
        "launches_per_tanks_map": tanks["fetch_launches"],
        **{f"{key}_{label}": round(t[i], 5) for label, t in fetch.items()
           for i, key in enumerate(("ms_per_map", "plain_ms_per_map", "bound_ms_per_map"))},
        "ms_source": "+".join(sorted({t[3] for t in fetch.values()})),
        "bound_by": "bytes", "library_ms": None,
        "work": "one forward's three PointFlow fetches, bf16 levels and output, V=5, G=5",
        "launches_per": "serving request (one a flow unbanded, one a band banded)",
    })
    rows.append({
        "name": "plane_sweep", "route": "cuda",
        "source": "pointmvsnet_tpu_torch/csrc/plane_sweep.cu",
        "replaces": "none (the JAX package leaves the sweep to XLA)",
        "launches": n_sweep, "max_abs_err": sweep_err,
        "launches_per_map": sweep_launches,
        **{f"{key}_{shape.replace(' ', '_')}": round(t[i], 5) for shape, t in sweep.items()
           for i, key in enumerate(("ms", "plain_ms", "bound_ms"))},
        "ms_source": "+".join(sorted({t[3] for t in sweep.values()})),
        "bound_by": "bytes", "library_ms": None,
        "work": "the coarse sweep (paper-eval, T&T) and CasMVSNet's three, bf16, V=5",
        "launches_per": "serving request",
    })
    rows.append({
        "name": "window_gather", "route": "cuda",
        "source": "pointmvsnet_tpu_torch/csrc/window_gather.cu",
        "replaces": "benchmarks/pallas_gather_probe.py:88",
        "launches": 0, "max_abs_err": gat["err"],
        "ms": round(gat["ms"], 5), "plain_ms": round(gat["plain_ms"], 4),
        "bound_ms": round(gat["bound_ms"], 5), "bound_by": gat["by"],
        "library_ms": round(gat["library_ms"], 5),
        "work": "probe default: N=327680 rows of W=128 f32, SPAN=2048",
        "launches_per": "serving request (the probe is off the model's path)",
        "launches_probe_entry_point": gat["probe_launches"],
    })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s from the "
          f"build's start", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
