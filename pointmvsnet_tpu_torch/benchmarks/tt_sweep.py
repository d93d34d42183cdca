"""Tanks & Temples-shape throughput sweep: the port's counterpart of
``benchmarks/tt_sweep.py``.

Runs the paper-eval pipeline (coarse + 3 PointFlow iterations, V=5, D=96,
BatchNorm eval, bf16) at T&T-relevant input sizes and band heights on
the card and prints one JSON line per token:
``{"variant", "maps_per_sec", "latency_s", "peak_gib"}`` (``peak_gib``:
``max_memory_allocated`` over the token's measurement, on CUDA only). A
T&T frame of 1920×1080 becomes 1920×1024 under ``crop_mvs_input(base=64)``.

    python -m pointmvsnet_tpu_torch.benchmarks.tt_sweep [tokens ...] \\
        [--out outputs/tt_sweep_torch.json] [--device cuda|cpu]

A token is ``engine[:chunk_rows]@WxH``: the flow fetch engine (the port
implements ``bilinear``), MODEL.FLOW_CHUNK_ROWS (default 128; 0 is
unbanded) and the input size. The results are merged into ``--out`` and
tokens already measured there are skipped, so an interrupted sweep
resumes. A forward that runs out of card memory is recorded as
``{"error": ...}`` and the sweep goes on; any other exception propagates.
Weights come from ``init_params`` with seed 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import torch

from pointmvsnet_tpu_torch.bench import build, make_inputs, measure
from pointmvsnet_tpu_torch.utils.convert import init_params

DEFAULT_TOKENS = [
    "bilinear:128@640x512",     # the DTU paper-eval size
    "bilinear:64@1280x1024",
    "bilinear:32@1280x1024",
    "bilinear:128@1280x1024",
]
KWARGS = dict(is_flow=True, img_scales=(0.25, 0.5, 1.0),
              inter_scales=(0.75, 0.375, 0.1875), num_virtual_plane=96)
VIEWS = 5
ITERS = 6


def parse_token(tok: str):
    """``engine[:chunk_rows]@WxH`` → (engine, chunk_rows, width, height)."""
    spec, shape = tok.split("@")
    engine, _, chunk = spec.partition(":")
    w, h = (int(x) for x in shape.split("x"))
    return engine, int(chunk or 128), w, h


def sweep(tokens, out: str, device="cuda") -> dict:
    """Measure every token not yet measured in ``out`` (a JSON file, created
    if missing, rewritten after each token) → every record of ``out``."""
    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    weights, inputs = None, {}
    for tok in tokens:
        if "maps_per_sec" in results.get(tok, {}):
            print(json.dumps({"variant": tok, "skip": "already measured", **results[tok]}),
                  flush=True)
            continue
        engine, chunk, w, h = parse_token(tok)
        _, model = build(fetch=engine, chunk_rows=chunk, device=device)
        if weights is None:
            weights = init_params(model, torch.Generator().manual_seed(0))
        model.load_state_dict(weights)
        if (h, w) not in inputs:
            inputs[(h, w)] = make_inputs(1, VIEWS, h, w, KWARGS["num_virtual_plane"],
                                         device=device)
        images, cams = inputs[(h, w)]
        cuda = images.is_cuda
        if cuda:
            torch.cuda.reset_peak_memory_stats(images.device)
        try:
            mps, lat = measure(model, images, cams, KWARGS, iters=ITERS)
            rec = {"maps_per_sec": round(mps, 4), "latency_s": round(lat, 4)}
            if cuda:
                rec["peak_gib"] = round(torch.cuda.max_memory_allocated(images.device) / 2 ** 30,
                                        3)
        except torch.cuda.OutOfMemoryError as e:
            rec = {"error": f"{type(e).__name__}: {e}"[:300]}
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        results[tok] = rec
        print(json.dumps({"variant": tok, **rec}), flush=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, out)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T&T-shape throughput sweep (PyTorch port)")
    ap.add_argument("tokens", nargs="*", help=f"engine[:chunk_rows]@WxH; default "
                                              f"{' '.join(DEFAULT_TOKENS)}")
    ap.add_argument("--out", default=os.path.join("outputs", "tt_sweep_torch.json"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return sweep(args.tokens or DEFAULT_TOKENS, args.out, args.device)


if __name__ == "__main__":
    main()
