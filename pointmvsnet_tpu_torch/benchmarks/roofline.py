"""Analytic roofline accounting for the headline DTU eval pipeline at the
card's peaks: the port's counterpart of ``benchmarks/roofline.py``.

Every hot stage of the paper-eval forward (640×512, V=5, D=96, coarse + 3
PointFlow iterations, bf16) gets its operations and the bytes it must
move, counted from the model's shapes, and the least time one NVIDIA
H100 SXM could take for them: the larger of the operations over the peak
rate of the units that run them and the bytes over the HBM rate. No
measurement goes into the table; ``measured_ms`` joins one in where the
caller has it.

Peaks (NVIDIA's data sheet, SXM part, dense, at its 700 W power limit; a
card set lower runs below them): 989 TFLOP/s bf16 on the tensor cores
(convolutions and the MLPs' matmuls), 67 TFLOP/s float32 outside them
(blends, moments, distances, the window max, the float32 resample
matmuls, which run with TF32 off), 3.35 TB/s HBM. A stage whose
operations run on both takes the longer of the two times.

Gathers are bytes here: each bilinear sample reads 4 taps, each a row of
C channels of a bf16 feature map, and each tap costs its row rounded up
to whole 32-byte sectors (``gather_taps`` counts the taps). The stages
whose work does not depend on the engine (``volume_unet``,
``flow_pyramid(all iters)``, ``flow3_knn``, ``flow3_edgeconv``,
``flow3_head_mlp``) keep the JAX tool's counts exactly; the three that
counted a TPU engine (``coarse_sweep_warp``, ``flow3_fetch``,
``ref_resample``) are counted for what the port runs.

Run:  python -m pointmvsnet_tpu_torch.benchmarks.roofline   (markdown + JSON)
Import: ``roofline_table()`` → list of stage dicts (the port's
``bench.py`` embeds it in its details file).
"""

from __future__ import annotations

import json

PEAK_BF16_TFLOPS = 989e12     # H100 SXM tensor cores, dense bf16, 700 W
PEAK_F32_TFLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_HBM_GBS = 3.35e12        # H100 SXM HBM3
SECTOR_BYTES = 32             # the unit a gathered row is read in
FEAT_BYTES = 2                # bf16 feature maps at the headline config


def _conv2d_flops(h, w, cin, cout, k, views=1):
    return 2 * h * w * cin * cout * k * k * views


def _image_conv_flops(h, w, c, views):
    """ImageConv pyramid FLOPs for one (B·V) call at input h×w (conv0..3
    stages; models/image_conv.py)."""
    f = 0
    f += _conv2d_flops(h, w, 3, c, 3, views) + _conv2d_flops(h, w, c, c, 3, views)
    h2, w2 = h // 2, w // 2
    f += (_conv2d_flops(h2, w2, c, 2 * c, 5, views)
          + 2 * _conv2d_flops(h2, w2, 2 * c, 2 * c, 3, views))
    h4, w4 = h // 4, w // 4
    f += (_conv2d_flops(h4, w4, 2 * c, 4 * c, 5, views)
          + 2 * _conv2d_flops(h4, w4, 4 * c, 4 * c, 3, views))
    h8, w8 = h // 8, w // 8
    f += (_conv2d_flops(h8, w8, 4 * c, 8 * c, 5, views)
          + 2 * _conv2d_flops(h8, w8, 8 * c, 8 * c, 3, views))
    return f


def _tap_bytes(c: int) -> int:
    """Bytes one tap of a C-channel bf16 row reads, in whole sectors."""
    return -(-c * FEAT_BYTES // SECTOR_BYTES) * SECTOR_BYTES


def _flow3_levels(h, w, base_c):
    """(rows, cols, channels) of the flow3 iteration's three feature levels
    (conv0..conv2 of the pyramid at full resolution)."""
    return [(h >> l, w >> l, base_c << l) for l in range(3)]


def gather_taps(h=512, w=640, v=5, d=96, g=5) -> dict:
    """Rows the port gathers per stage (4 taps per bilinear sample, B=1):
    the plane sweep samples each source view at every (plane, pixel) of
    the 1/8 feature map (``ops/cost_volume.py::plane_sweep_volume`` →
    ``fetch_features``); flow3 samples each source view at every
    hypothesis point on each of three levels
    (``ops/sampling.py::fetch_features_perlevel``); the reference view's
    resample gathers nothing (``regular_grid_sample``: two matmuls)."""
    src = v - 1
    return {"coarse_sweep_warp": 4 * src * d * (h // 8) * (w // 8),
            "flow3_fetch": 4 * src * g * h * w * 3,
            "ref_resample": 0}


def ref_resample_flops(h=512, w=640, base_c=8) -> int:
    """Operations of ``regular_grid_sample`` for the three flow3 levels:
    a column then a row interpolation matmul per level."""
    return sum(2 * c * w * rh * (rw + h) for rh, rw, c in _flow3_levels(h, w, base_c))


def roofline_table(h=512, w=640, v=5, d=96, g=5, base_c=8,
                   edge_channels=(32, 32, 64), flow_channels=(64, 64, 16, 1),
                   knn_window=5, k=16, measured_ms=None):
    """Per-stage FLOPs / bytes / binding resource at the eval config.

    ``measured_ms``: optional dict of stage → measured time (ms) to join
    in; none by default (the JAX tool's default holds TPU marginals)."""
    measured_ms = measured_ms or {}
    cs = (base_c, 2 * base_c, 4 * base_c)          # pyramid channels 8/16/32
    sum_c = sum(cs)                                # 56
    n = h * w                                      # flow3 points per hypo
    gn = g * n
    src = v - 1
    taps = gather_taps(h, w, v, d, g)
    stages = []

    def add(name, stream_bytes, tc_flops=0, f32_flops=0, gather_rows=0, note=""):
        t_compute = max(tc_flops / PEAK_BF16_TFLOPS, f32_flops / PEAK_F32_TFLOPS)
        t_bw = stream_bytes / PEAK_HBM_GBS
        stages.append({
            "stage": name,
            "gflops": round((tc_flops + f32_flops) / 1e9, 1),
            "stream_mb": round(stream_bytes / 1e6, 1),
            "gather_rows_m": round(gather_rows / 1e6, 2),
            "ceiling_ms": round(max(t_compute, t_bw) * 1e3, 4),
            "bound_by": "compute" if t_compute > t_bw else "bandwidth",
            "measured_ms": measured_ms.get(name),
            "note": note,
        })

    # --- coarse stage -----------------------------------------------------
    ch, cw = h // 8, w // 8                        # coarse feature res 64x80
    samples = src * d * ch * cw
    add("coarse_sweep_warp",
        stream_bytes=(taps["coarse_sweep_warp"] * _tap_bytes(cs[2])   # gathered taps
                      + ch * cw * cs[2] * FEAT_BYTES                  # reference map
                      + d * ch * cw * cs[2] * 4),                     # f32 cost volume
        f32_flops=(samples * cs[2] * 8                    # 4-tap blend
                   + v * d * ch * cw * cs[2] * 3          # Σf, f², Σf²
                   + d * ch * cw * cs[2] * 4),            # variance
        gather_rows=taps["coarse_sweep_warp"],
        note="csrc/plane_sweep.cu via ops/cost_volume.py::plane_sweep_volume (eval "
             "on the card; the composition elsewhere): 4 bilinear taps of a C=32 "
             "bf16 row per (source view, plane, pixel), then the variance over the "
             "views; the reference view adds its own map. Counted as the "
             "composition's passes, as the JAX table counts them")
    add("volume_unet",
        stream_bytes=4 * d * ch * cw * cs[2] * 4,
        tc_flops=2 * 60 * d * ch * cw * 8 * 8 * 27,       # ~3D U-Net conv stack
        note="models/volume_conv.py: 3-level 3D U-Net over (D,h/8,w/8), bf16 "
             "convolutions; rough conv count")
    add("flow_pyramid(all iters)",
        stream_bytes=2 * v * (h * w * 3 + h * w * base_c * 2) * 4,
        tc_flops=_image_conv_flops(h, w, base_c, v)
        + _image_conv_flops(h // 4, w // 4, base_c, v),
        note="models/image_conv.py: shared 2D CNN, views folded into the batch, "
             "bf16 convolutions (flow1 reuses the coarse pyramid)")

    # --- flow3 iteration (dominant) ---------------------------------------
    add("flow3_fetch",
        stream_bytes=(src * gn * 4 * sum(_tap_bytes(c) for c in cs)   # gathered taps
                      + 2 * gn * sum_c * 4),                          # f32 Σf, Σf²
        f32_flops=src * gn * sum_c * (8 + 3),             # blend, moments
        gather_rows=taps["flow3_fetch"],
        note="ops/sampling.py::fetch_features_perlevel: 4 bilinear taps per "
             "(source view, hypothesis point, level) of 8/16/32-channel bf16 "
             "rows (index_select), reduced over the views to f32 moments")
    add("ref_resample",
        stream_bytes=(sum(rh * rw * c * FEAT_BYTES + n * c * 4
                          for rh, rw, c in _flow3_levels(h, w, base_c))
                      + gn * sum_c * 4),                  # masked over the G hypotheses
        f32_flops=ref_resample_flops(h, w, base_c),
        note="ops/sampling.py::regular_grid_sample: the reference view at the "
             "regular grid, two f32 interpolation matmuls per level, then "
             "broadcast over the G hypotheses (models/pointmvsnet.py::PointFlow)")
    # kNN: windowed distance + top-k over the structured grid
    win_pts = g * knn_window * knn_window
    add("flow3_knn",
        stream_bytes=gn * (3 * 4 + k * 4),
        f32_flops=2 * gn * win_pts * 3 + gn * win_pts * 8,
        note="csrc/window_knn.cu: f32 distances over the window and the "
             "selection of the k nearest")
    # EdgeConv stack: SharedMLP matmuls + masked-window-max
    mlp = cmp = 0
    cin = sum_c
    for cout in edge_channels:
        mlp += 2 * gn * (2 * cin) * cout           # edge MLP (concat trick)
        cmp += gn * cout * win_pts                 # window-max compare ops
        cin = cout
    add("flow3_edgeconv",
        stream_bytes=gn * (sum_c + sum(edge_channels)) * 4 * 2,
        tc_flops=mlp, f32_flops=cmp,
        note="models/edge_conv.py: split matmuls on the tensor cores, then "
             "csrc/masked_window_max.cu (compares counted as float32 operations)")
    f_head = 0
    cin = sum(edge_channels)
    for cout in flow_channels:
        f_head += 2 * gn * cin * cout
        cin = cout
    add("flow3_head_mlp",
        stream_bytes=gn * (sum(edge_channels) + flow_channels[0]) * 4,
        tc_flops=f_head,
        note="models/blocks.py::SharedMLP logits head, bf16 matmuls")
    return stages


def main():
    stages = roofline_table()
    hdr = ("| stage | GFLOP | stream MB | gather Mrows | ceiling ms | "
           "bound by | measured ms |")
    print(hdr)
    print("|" + "---|" * 7)
    for s in stages:
        print(f"| {s['stage']} | {s['gflops']} | {s['stream_mb']} | "
              f"{s['gather_rows_m']} | {s['ceiling_ms']} | {s['bound_by']} | "
              f"{s['measured_ms']} |")
    print()
    print(json.dumps(stages, indent=1))


if __name__ == "__main__":
    main()
