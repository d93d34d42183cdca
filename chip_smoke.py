"""On-card smoke test of the PyTorch / CUDA port (pointmvsnet_tpu_torch).

    python3 chip_smoke.py          # one NVIDIA H100 (sm_90a), CUDA toolkit with nvcc

Phases, one or more lines each; any failure raises and exits non-zero:

1. env     torch / CUDA versions, card name and power limit; TF32 off for
           the f32 phases.
2. build   nvcc builds both kernels from csrc/, in parallel.
3. kernels each CUDA kernel against its plain PyTorch version on the card,
           at every shape the paper-eval forward gives it: windowed kNN
           (idx and mask bit-equal) and masked window max (bit-equal, bf16
           and f32); the kernel's device time (torch.profiler), the plain
           version's time (CUDA events), and the bound of the same work.
4. parity  the port at 64×128, V=3, D=16, f32: card (kernels) against the
           CPU (plain versions), same seeded weights; depth bars of
           tests/test_full_parity.py.
5. serve   Predictor at the paper-eval config (640×512, V=5, D=96, bf16,
           BatchNorm eval, 3 PointFlow iterations) answers 3 requests on a
           synthetic scene; each must launch exactly 3 kNN and 9 masked-max
           kernels and return finite maps; one more request runs under
           the profiler (device busy share, top kernels).

Then a JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
                check(torch.equal(out, ref),
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


def phase_parity():
    from pointmvsnet_tpu_torch.config import get_default_cfg
    from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import init_params

    cfg = get_default_cfg()
    images, cams, _ = make_scene_batch(1, 3, 64, 128, 16)
    kw = dict(img_scales=(0.25, 0.5, 1.0), inter_scales=(0.75, 0.375, 0.1875),
              num_virtual_plane=16)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        if dev == "cuda":
            sd = init_params(model, torch.Generator().manual_seed(0))
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs[dev] = {k: v.float().cpu() for k, v in model(
                torch.tensor(images, device=dev), torch.tensor(cams, device=dev), **kw).items()}
    report = []
    for key in ("coarse_depth_map", "flow1", "flow2", "flow3"):
        d = (outs["cuda"][key] - outs["cpu"][key]).abs()
        report.append(f"{key} max {d.max().item():.3e} mean {d.mean().item():.3e}")
        check(d.max().item() < 0.05 and d.mean().item() < 0.005,
              f"parity {key}: max {d.max().item()} mean {d.mean().item()}")
    c = (outs["cuda"]["coarse_prob_map"] - outs["cpu"]["coarse_prob_map"]).abs().max().item()
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
    launches = knn.launches, edge.launches
    profile_request(pred, images[0], cams[0])
    return launches


def profile_request(pred, images, cams, top: int = 12):
    """One more request under torch.profiler: device busy time (the sum of
    the GPU kernels and copies), its share of the request's wall time, and
    the operators whose kernels take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(images, cams)
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    on_gpu = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_gpu) / 1e3
    print(f"profile: request under the profiler {wall:.1f} ms wall, device busy "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pointmvsnet_tpu_torch.ops import _cuda

    card = smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; {card}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    _cuda.build()
    print(f"build: {sorted(_cuda.SIGNATURES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    tot = phase_kernels(dev)
    phase_parity()
    n_knn, n_mwm = phase_serve()

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
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
