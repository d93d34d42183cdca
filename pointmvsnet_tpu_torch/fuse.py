"""Depth-fusion entry point: exported depth maps → one fused point cloud
(PLY) per scan. Counterpart of ``pointmvsnet_tpu/fuse.py``.

    python -m pointmvsnet_tpu_torch.fuse --depth_dir outputs/dtu_wde3/depths \\
        --out clouds [--backend torch|numpy] [--device cuda|cpu] \\
        [--prob_threshold 0.8 --min_views 3 --gt_dir ...]

Reads each ``scan*/`` directory that ``utils/eval_file_logger.py`` wrote
(the last ``*_flowN.pfm`` or ``*_init.pfm`` depth, ``*_prob.pfm``,
``*.txt`` cam, ``*.png`` colours), fuses it, writes ``<out>/scan<n>.ply``
and ``<out>/fusion_results.json``, and with ``--gt_dir`` (GT
``scan<n>.ply`` files) adds accuracy / completeness / overall. The
default backend is the torch twin on the card (the JAX CLI defaults to
numpy on the host); a scan whose maps differ in shape takes the numpy
path, and each scan's line says which backend it used.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from pointmvsnet_tpu_torch import resolve_device
from pointmvsnet_tpu_torch.dataset.io import load_cam, load_pfm, read_png
from pointmvsnet_tpu_torch.dataset.preprocess import resize_image
from pointmvsnet_tpu_torch.postprocess import (
    fuse_depth_maps,
    point_cloud_metrics,
    read_ply,
    write_ply,
)


def fuse_scan(scan_dir: str, prob_threshold: float = 0.8,
              pix_threshold: float = 1.0, depth_threshold: float = 0.01,
              min_views: int = 3, backend: str = "torch", device="cuda"):
    """→ (points, colors, backend used) for one exported scan directory."""
    stems = sorted(set(
        re.sub(r"_(init|flow\d+|prob)\.pfm$", "", p)
        for p in glob.glob(os.path.join(scan_dir, "*.pfm"))))
    depths, cams, probs, images = [], [], [], []
    for stem in stems:
        flows = sorted(glob.glob(stem + "_flow*.pfm"))
        d = load_pfm(flows[-1] if flows else stem + "_init.pfm")
        prob_path = stem + "_prob.pfm"
        p = load_pfm(prob_path) if os.path.isfile(prob_path) else None
        if p is not None and p.shape != d.shape:
            # the probability map is at the coarse resolution: nearest upsampling
            ys = (np.arange(d.shape[0]) * p.shape[0] // d.shape[0]).clip(0, p.shape[0] - 1)
            xs = (np.arange(d.shape[1]) * p.shape[1] // d.shape[1]).clip(0, p.shape[1] - 1)
            p = p[ys][:, xs]
        depths.append(d)
        cams.append(load_cam(stem + ".txt"))
        probs.append(p)
        if os.path.isfile(stem + ".png"):
            im = read_png(stem + ".png")
            if im.shape[:2] != d.shape:
                im = resize_image(im, d.shape, interpolation="linear")
            images.append(im.astype(np.float32))
    kw = dict(probs=probs if all(p is not None for p in probs) else None,
              images=images if len(images) == len(depths) else None,
              prob_threshold=prob_threshold, pix_threshold=pix_threshold,
              depth_threshold=depth_threshold, min_views=min_views)
    if backend == "torch" and len({d.shape for d in depths}) == 1:
        from pointmvsnet_tpu_torch.postprocess.fusion_torch import fuse_depth_maps_torch
        return (*fuse_depth_maps_torch(depths, cams, device=device, **kw), "torch")
    return (*fuse_depth_maps(depths, cams, **kw), "numpy")


def main(argv=None):
    ap = argparse.ArgumentParser(description="fuse exported depth maps (PyTorch port)")
    ap.add_argument("--depth_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prob_threshold", type=float, default=0.8)
    ap.add_argument("--pix_threshold", type=float, default=1.0)
    ap.add_argument("--depth_threshold", type=float, default=0.01)
    ap.add_argument("--min_views", type=int, default=3)
    ap.add_argument("--gt_dir", default="", help="dir of GT scan<N>.ply for metrics")
    ap.add_argument("--backend", default="torch", choices=["torch", "numpy"],
                    help="torch = the consistency sweep on --device (needs uniform "
                         "per-scan shapes; other scans take numpy)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.backend == "torch":
        resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for scan_dir in sorted(glob.glob(os.path.join(args.depth_dir, "scan*"))):
        scan = os.path.basename(scan_dir)
        pts, cols, used = fuse_scan(scan_dir, args.prob_threshold, args.pix_threshold,
                                    args.depth_threshold, args.min_views,
                                    backend=args.backend, device=args.device)
        out_path = os.path.join(args.out, scan + ".ply")
        write_ply(out_path, pts, cols)
        entry = {"n_points": int(len(pts)), "ply": out_path, "backend": used}
        gt_path = os.path.join(args.gt_dir, scan + ".ply") if args.gt_dir else ""
        if gt_path and os.path.isfile(gt_path):
            gt_pts, _ = read_ply(gt_path)
            entry.update(point_cloud_metrics(pts, gt_pts))
        results[scan] = entry
        print(scan, json.dumps(entry), flush=True)
    with open(os.path.join(args.out, "fusion_results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
