"""Probe: the windowed row gather against a plain row gather, on the card.

Counterpart of ``benchmarks/pallas_gather_probe.py``, which asked whether a
Pallas kernel serving a coherent index stream from a two-slab VMEM window
beats XLA's row gather. Here the same inputs (own numpy copy of its
``make_inputs``) go through three versions of ``out[i] = table[idx[i]]``:

  index_select — ``torch.index_select`` (the library call; the probe's
                 ``xla_take`` baseline)
  plain        — ``ops/window_gather.py::window_gather_plain`` (q / rel
                 window arithmetic, then ``index_select``)
  kernel       — ``csrc/window_gather.cu`` through ``window_gather``

Each line gives ms per call (CUDA events, mean over ``iters`` calls after a
warm-up; ``prepare`` runs once beforehand and is not timed), Mrows/s, output
GB/s and ``exact=`` against ``index_select``.

    python -m pointmvsnet_tpu_torch.benchmarks.pallas_gather_probe [N] [W] [SPAN]

Runs on CUDA; ``run(..., device="cpu")`` times the plain versions with the
host clock instead.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from pointmvsnet_tpu_torch import resolve_device
from pointmvsnet_tpu_torch.ops.window_gather import (
    BLOCK,
    prepare,
    window_gather,
    window_gather_plain,
)

TABLE_ROWS = 641 * 513          # the probe's table: one padded flow3 map


def make_inputs(n_rows_table: int, n_points: int, width: int, seed: int = 0):
    """Coherent index stream: monotone-ish rows like epipolar projections
    (consecutive points land within a few hundred table rows). Same numbers
    as the JAX probe's ``make_inputs``. → (table (R, W) f32, idx (N,) i32)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n_rows_table, width).astype(np.float32)
    base = np.linspace(0, n_rows_table - 700, n_points)
    idx = (base + rng.randint(0, 640, n_points)).astype(np.int32)
    idx = np.clip(idx, 0, n_rows_table - 1)
    return table, idx


def _time_ms(fn, dev: torch.device, iters: int) -> float:
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(n: int = 512 * 640, width: int = 128, span: int = 2048,
        n_rows_table: int = TABLE_ROWS, device="cuda", iters: int = 30,
        verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """Time the three versions; → {name: {ms, mrows_s, gbps, exact}}."""
    dev = resolve_device(device)
    n = (n // BLOCK) * BLOCK
    table_np, idx_np = make_inputs(n_rows_table, n, width)
    table = torch.from_numpy(table_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    table_p, q, rel = prepare(table, idx, span)
    ref = table.index_select(0, idx.long())
    if verbose:
        print(f"N={n} width={width} span={span} table={tuple(table.shape)} "
              f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
              flush=True)
    versions = {
        "index_select": lambda: table.index_select(0, idx.long()),
        "plain": lambda: window_gather_plain(table_p, q, rel, span),
        "kernel": lambda: window_gather(table_p, q, rel, span),
    }
    out = {}
    for name, fn in versions.items():
        exact = bool(torch.equal(fn(), ref))
        ms = _time_ms(fn, dev, iters)
        out[name] = dict(ms=ms, mrows_s=n / ms / 1e3, gbps=ref.nbytes / ms / 1e6,
                         exact=exact)
        if verbose:
            print(f"{name:12s}: {ms:7.3f} ms  {n / ms / 1e3:8.1f} Mrows/s  "
                  f"{ref.nbytes / ms / 1e6:6.1f} GB/s out  exact={exact}", flush=True)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 512 * 640
    width = int(argv[1]) if len(argv) > 1 else 128
    span = int(argv[2]) if len(argv) > 2 else 2048
    run(n, width, span)


if __name__ == "__main__":
    main()
