"""On-card smoke test of the PyTorch / CUDA port (pointmvsnet_tpu_torch).

    python3 chip_smoke.py          # one NVIDIA H100 (sm_90a), CUDA toolkit with nvcc

Phases, one or more lines each; any failure raises and exits non-zero:

1. env     torch / CUDA versions, card name and power limit, and torch's
           TF32 flags as the process starts. The script does not set them:
           each entry point turns TF32 off itself, and the parity, train
           and export phases check that it did (flags off after
           ``Predictor``, ``train()`` and ``test.test``, each entered with
           TF32 allowed), so every f32 gate holds for what users get.
2. build   nvcc builds the three kernels from csrc/, in parallel.
3. kernels each CUDA kernel of the model against its plain PyTorch version
           on the card, at every shape the paper-eval forward gives it:
           windowed kNN (idx and mask bit-equal) and masked window max
           (bit-equal, bf16 and f32); the kernel's device time
           (torch.profiler), the plain version's time (CUDA events), and
           the bound of the same work. Then inputs meant to break them:
           the kNN on integer-lattice points (exact d² ties), on
           duplicated hypothesis levels and on grids that are not a
           multiple of its tile; the masked max on NaN rows, on {−0, +0,
           ±1} (signed zeros, exact ties), under kNN masks and random ones
           (out-of-image bits, bits past G·25, empty masks), in bf16 and
           f32, at widths that take its vector and its scalar path; each
           against the plain version on the card and (on the small grids)
           on the CPU, NaN positions first, then the bits of the rest.
4. gather  the probe's windowed row gather (csrc/window_gather.cu) against
           its plain version, bit-equal, at the probe's default shape and
           at one whose rows fill the upper slab and the padded last
           window; kernel, plain, torch.index_select and bound times; then
           the probe's own entry point.
5. parity  the port at 64×128, V=3, D=16, f32, through Predictor: card
           (kernels) against the CPU (plain versions), same seeded
           weights; depth bars of tests/test_full_parity.py.
6. serve   Predictor at the paper-eval config (640×512, V=5, D=96, bf16,
           BatchNorm eval, 3 PointFlow iterations) answers 3 requests on a
           synthetic scene; each must launch exactly 3 kNN and 9 masked-max
           kernels and return finite maps; one more request runs under
           the profiler (device busy share, top kernels).
7. train   train() at the reference training config (640×512, V=3, D=48,
           B=4, BatchNorm, f32, flows at 0.25 / 0.5) on a synthetic DTU
           tree written by the port: 2 coarse-only and 2 flow steps with
           validation, a checkpoint, and a resume to 6 steps; kernel
           launches per flow step and validation batch; every kernel call
           of one validation batch (B=4) bit-equal to its plain version on
           the same inputs; steady step time, peak memory and the
           device-busy share of one profiled step.
8. train-parity  EdgeConv's train-mode backward on a fixed kNN graph,
           card against CPU; then one train step at 64×128, V=3, D=16, B=2,
           f32, seeded weights and noisy images, coarse-only and with both
           flows, the kNN fed the same points on both sides: card against CPU,
           losses, every gradient and the BN running statistics, with the
           bars set out in phase_train_parity.
9. export  the eval pipeline: a DTU eval-release tree of 800×640 JPEGs
           (scan 1, 5 views, D=96) written by the port's JPEG writer; the
           test CLI (configs/dtu_wde3.yaml, bf16, TEST.WEIGHT = the train
           phase's last checkpoint) decodes, scales by 0.8 to 640×512 and
           exports 5 maps, each with exactly 3 kNN and 9 masked-max
           launches; one exported flow3 map against Predictor on the same
           item; the fuse CLI with the torch backend on the card, with
           numpy and with torch on the CPU, each pair held to the JAX
           package's bar between its backends (equal counts, 1e-3).
10. weights  the weights the JAX package loads. A reference-layout .pth
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
11. fusion-scan  both fusion backends on 49 noisy true depth maps of
           640×512 (a DTU eval scan's view count) at the fuse CLI's
           defaults: times, the card's peak memory, each cloud's accuracy
           / completeness against the scene; the card held to torch on the
           CPU on 9 of the maps (bars in phase_fusion_scan).
12. train-bf16  the train phase with MODEL.DTYPE bfloat16: step counter,
           checkpoints and resume, 0 skipped steps, finite parameters, 2
           kNN and 0 masked-max launches per flow step, 2 kNN and 6
           masked-max (bf16; 4 at F=32, 2 at F=64) per validation batch,
           the validation batch's kernel calls bit-equal to their plain
           versions, step time and peak memory beside the f32 phase's, a
           profiled step; then one B=2 BatchNorm bf16 flow step, finite.
13. train-dp  train() inside a one-rank NCCL group bit-equal to train()
           without a group (2 + 2 steps, deterministic algorithms, in a
           process of its own); then two ranks on cuda:0 over gloo at
           64×128, global B=4, BN, f32 and bf16, a coarse-only and a flow
           step each, against the one-rank step at B=4 on the card, with
           the bars of tests/test_torch_distributed.py (printed). One card
           cannot show NCCL between cards.

Then a JSON line of per-kernel numbers (``launches`` per serving request;
per train step and validation batch in f32 and in bf16; per exported
map; per request from converted weights), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. ``--phases train,train-bf16,train-dp,
weights`` (any subset of the four) runs only those, to try them on the
card, and prints no result lines. Imports nothing of JAX.
"""

from __future__ import annotations

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
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


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


def knn_bound(h: int, w: int):
    """(bytes, flops) of one windowed-kNN call: coords in, idx and mask
    out; 8 flops per (query, in-image candidate)."""
    p = G * h * w
    nw = -(-(G * WIN * WIN) // 32)
    ny = sum(min(h - 1, y + 2) - max(0, y - 2) + 1 for y in range(h))
    nx = sum(min(w - 1, x + 2) - max(0, x - 2) + 1 for x in range(w))
    return p * 12 + p * K * 4 + p * nw * 4, 8 * G * G * ny * nx


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
        pop = sum(((mask.long() >> s) & 1) for s in range(32)).sum().item()
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
                size = z.element_size()
                nbytes = 2 * z.numel() * size + mask.numel() * 4
                bb, by = bound_ms(nbytes, pop * f)
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


def random_mask(b: int, g: int, h: int, w: int, dev, seed: int) -> torch.Tensor:
    """Selection bitplanes no kNN makes: a quarter of all 128 bits set
    (out-of-image bits and bits past G·25 included), 10% of the points
    empty."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nw = -(-(g * WIN * WIN) // 32)
    shape = (b, nw, g, h, w)
    words = [torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, device=dev,
                           dtype=torch.int64) for _ in range(2)]
    keep = torch.rand((b, 1, g, h, w), generator=gen, device=dev) >= 0.1
    return ((words[0] & words[1]) * keep).to(torch.int32)


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
        rng = np.random.RandomState(gi)
        cases = {"random": rng.rand(b, p, 3) * 10,
                 "lattice": rng.randint(0, 3, (b, p, 3)),
                 "duplicates": np.broadcast_to(
                     (rng.rand(b, 1, h, w, 3) * 10), (b, g, h, w, 3)).reshape(b, p, 3)}
        for case, arr in cases.items():
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


def phase_parity():
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils.convert import init_params

    cfg = get_default_cfg()
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
        check(d.max() < 0.05 and d.mean() < 0.005, f"parity {key}: max {d.max()} mean {d.mean()}")
    c = float(np.abs(outs["cuda"]["coarse_prob_map"] - outs["cpu"]["coarse_prob_map"]).max())
    check(c < 0.02, f"parity confidence: max {c}")
    print(f"parity: f32 card vs cpu at 64x128 V=3 D=16: {'; '.join(report)}; "
          f"confidence max {c:.3e}", flush=True)


def phase_serve():
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.ops import edge, knn
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
    latencies = []
    for r in range(3):
        k0, e0 = knn.launches, edge.launches
        t0 = time.perf_counter()
        out = pred(images[0], cams[0])           # returns numpy: synchronized
        latencies.append((time.perf_counter() - t0) * 1e3)
        nk, ne = knn.launches - k0, edge.launches - e0
        check((nk, ne) == (3, 9), f"request {r}: {nk} kNN and {ne} masked-max launches, "
                                  f"want 3 and 9")
        check(out["depth"].shape == (h, w) and out["confidence"].shape == (h // 8, w // 8),
              f"request {r}: shapes {out['depth'].shape} {out['confidence'].shape}")
        check(all(np.isfinite(a).all() for a in out.values()), f"request {r}: non-finite")
        print(f"serve: request {r}: {latencies[-1]:.1f} ms, launches knn {nk} "
              f"masked_window_max {ne}, depth [{out['depth'].min():.2f}, "
              f"{out['depth'].max():.2f}] (true {gt.min():.1f}/{gt.max():.1f})", flush=True)
    print(f"serve: 640x512 V={v} D={d} bf16, 3 flows: latency ms {latencies}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    profile_call(lambda: pred(images[0], cams[0]), "request")
    return nk, ne                     # one request's launches (checked equal for all)


def _train_step_once(dev, kw, batch, sd, knn_hook=None):
    """One train step of the default-width model (f32, unmasked loss) from
    the state_dict ``sd`` on ``dev``; ``knn_hook`` wraps the model's kNN.
    → (losses, grads, BN statistics), on the CPU."""
    import pointmvsnet_tpu_torch.models.pointmvsnet as pmodel
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step, put_batch
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    cfg = get_default_cfg()
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


def phase_train_parity():
    """One train step of the default-width model, card against CPU,
    coarse-only and with both flows. The card's kNN kernel gets the CPU
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
    cfg = get_default_cfg()
    sd = init_params(build_model(cfg, "cpu"), torch.Generator().manual_seed(0))
    n_head = len(cfg.MODEL.FLOW_CHANNELS)
    shift_invariant = ("vol_conv.convs.7.conv.bias",
                       f"point_flow.head.layers.{n_head - 1}.linear.bias")
    for is_flow in (False, True):
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

        cpu = _train_step_once("cpu", kw, batch, sd, record)
        check(len(points) == (2 if is_flow else 0), f"{len(points)} kNN calls on the CPU")
        card = _train_step_once("cuda", kw, batch, sd, replay)
        check(not points, "the card step did not run its kNN")
        for k, v in cpu[0].items():
            check(np.isfinite(card[0][k]) and abs(card[0][k] - v) <= 1e-4 * abs(v),
                  f"train-parity loss {k}: card {card[0][k]} cpu {v}")
        largest = max(float(g.abs().max()) for g in cpu[1].values())
        rel = 0.5 if is_flow else 1e-4
        gaps = []
        for name, g in cpu[1].items():
            tg = card[1][name]
            if name in shift_invariant:
                check(max(float(g.abs().max()), float(tg.abs().max())) < 1e-5 * largest,
                      f"train-parity {name}: not ~0")
                continue
            # parameters no output uses have zero gradients on both sides
            gap = float((tg - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            check(gap <= rel, f"train-parity grad {name}: max |Δg| {gap:.3e} of max |g|")
            gaps.append((gap, name))
        gaps.sort(reverse=True)
        sdiff = max(float((card[2][n] - v).abs().max()) for n, v in cpu[2].items())
        check(sdiff <= 1e-5, f"train-parity BN statistics: max |Δ| {sdiff:.3e}")
        print(f"train-parity: {'flows on' if is_flow else 'coarse-only'} step at 64x128 "
              f"V=3 D=16 B=2 f32, card vs cpu: losses "
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
            t0 = time.perf_counter()
            state = train(cfg, out, max_steps_per_epoch=2, device="cuda")
            torch.cuda.synchronize()
            if max_epoch == 2:
                check_f32(f"train() ({label})")
            got = (knn.launches, edge.launches)
            check(state.step == steps, f"{name}: step counter {state.step}, want {steps}")
            check(state.optimizer.skipped_steps == 0, f"{name}: skipped a non-finite step")
            check(got == want, f"{name}: launches kNN/masked-max {got}, want {want}")
            ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
            check(f"{max_epoch - 1}.pt" in ckpts, f"{name}: checkpoints {ckpts}")
            check(all(torch.isfinite(p).all() for p in state.model.parameters()),
                  f"{name}: non-finite parameters")
            print(f"{name}: MAX_EPOCH={max_epoch} B={b} {label}: step counter {state.step}, "
                  f"checkpoints {ckpts}, skipped steps 0, launches kNN {got[0]} masked-max "
                  f"{got[1]}, {time.perf_counter() - t0:.1f} s", flush=True)

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
    from pointmvsnet_tpu_torch import fuse
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
    t0 = time.perf_counter()
    summary, depth_dir = test_cli.main(args)
    t_cli = time.perf_counter() - t0
    check_f32("test.test (the test CLI)")
    nk, ne = knn.launches, edge.launches
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
          f"{ne // n_maps}; {smi_line()}", flush=True)

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
    pairs = {f"{a}-{b}": compare_clouds(clouds[a], clouds[b])
             for a, b in (("card", "numpy"), ("card", "cpu"), ("cpu", "numpy"))}
    print(f"export: fuse CLI at prob 0, 2 views, {views} maps of {flow3.shape[1]}x"
          f"{flow3.shape[0]}: torch on the card {secs['card']:.3f} s, numpy "
          f"{secs['numpy']:.3f} s, torch on the CPU {secs['cpu']:.3f} s (CLI wall, PFM reads "
          f"and PLY write included); clouds {json.dumps(pairs)}; {smi_line()}", flush=True)
    for name, c in pairs.items():
        check(clouds_agree(c), f"fuse {name}: {c}")
    return nk // n_maps, ne // n_maps


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


PHASES = ["env", "build", "kernels", "adversarial", "gather", "parity", "serve", "train",
          "train-parity", "export", "weights", "fusion-scan", "train-bf16", "train-dp"]


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="On-card smoke test of the PyTorch / CUDA port")
    p.add_argument("--phases", default="",
                   help="comma-separated subset of train,train-bf16,train-dp,weights to try "
                        "on the card (prints no result lines); default: every phase")
    args = p.parse_args(argv)
    phases = ["env", "build"] + args.phases.split(",") if args.phases else PHASES
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pointmvsnet_tpu_torch.ops import _cuda

    import warnings

    from pointmvsnet_tpu_torch import disable_tf32

    card = smi_line()
    found = tf32_flags()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        disable_tf32()                      # counted, then the flags are put back
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = found
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; {card}; TF32 flags as "
          f"found: cudnn.allow_tf32={found[0]} matmul.allow_tf32={found[1]}; "
          f"disable_tf32 warned {len(caught)} time(s) {[str(w.message)[:80] for w in caught]}",
          flush=True)

    t0 = time.perf_counter()
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
            if name == "train-bf16":
                phase_train_bf16(dev, per_train)
            elif name == "train-dp":
                phase_train_dp(dev)
            elif name == "weights":
                work = tempfile.mkdtemp(prefix="chip_smoke_weights_")
                try:
                    phase_weights(work)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
            elif name != "train":
                fail(f"--phases: {name} runs only in a whole run")
        print(f"chip_smoke: partial run of {phases}: every check passed")
        return 0
    tot = phase_kernels(dev)
    phase_adversarial(dev)
    gat = phase_gather(dev)
    phase_parity()
    n_knn, n_mwm = phase_serve()
    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        weight = os.path.join(work, "trained.pt")
        per_train = phase_train(dev, weight)
        phase_edge_conv_backward()
        phase_train_parity()
        per_map = phase_export(weight, work)
        per_weights = phase_weights(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_fusion_scan()
    per_bf16 = phase_train_bf16(dev, per_train)
    phase_train_dp(dev)

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
            "launches_per_bf16_train_step": per_bf16[name][0],
            "launches_per_bf16_val_batch": per_bf16[name][1],
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
