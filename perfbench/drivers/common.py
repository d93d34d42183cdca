"""What the drivers share: the program's configuration from a config
file, the forward's options, the weights' template and the reference's
outputs for a scene."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import inputs
from perfbench.check import FLOWS, map_numbers, step_numbers, worst
from perfbench.reference import model as ref


def program_cfg(config: Dict, block: str):
    """A config file and its ``eval`` or ``train`` block → the program's
    config node."""
    from pointmvsnet_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    for key, value in config["model"].items():
        cfg.MODEL[key] = tuple(value) if isinstance(value, list) else value
    b = config[block]
    cfg.MODEL.DTYPE = b["dtype"]
    cfg.MODEL.FLOW_CHUNK_ROWS = b["flow_chunk_rows"]
    if block == "eval":
        cfg.DATA.TEST.NUM_VIEW = b["views"]
        cfg.DATA.TEST.NUM_VIRTUAL_PLANE = b["num_depth"]
        cfg.DATA.TEST.IMG_HEIGHT, cfg.DATA.TEST.IMG_WIDTH = b["height"], b["width"]
        cfg.MODEL.TEST.IMG_SCALES = tuple(b["img_scales"])
        cfg.MODEL.TEST.INTER_SCALES = tuple(b["inter_scales"])
    else:
        cfg.DATA.TRAIN.NUM_VIEW = b["views"]
        cfg.MODEL.NUM_VIRTUAL_PLANE = b["num_depth"]
        cfg.TRAIN.BATCH_SIZE = b["batch"]
        cfg.MODEL.TRAIN.IMG_SCALES = tuple(b["img_scales"])
        cfg.MODEL.TRAIN.INTER_SCALES = tuple(b["inter_scales"])
        for key, value in b["solver"].items():
            if key in ("ALPHA", "EPS"):
                cfg.SOLVER.RMSPROP[key] = value
            else:
                cfg.SOLVER[key] = value
        cfg.SCHEDULER.STEP_LR.STEP_SIZE = b["scheduler"]["STEP_SIZE"]
        cfg.SCHEDULER.STEP_LR.GAMMA = b["scheduler"]["GAMMA"]
    return cfg


def forward_kwargs(block: Dict) -> Dict:
    return dict(is_flow=True, img_scales=tuple(block["img_scales"]),
                inter_scales=tuple(block["inter_scales"]), num_virtual_plane=block["num_depth"])


def seeded_weights(config: Dict, seed: int, device,
                   calibrate: bool = False) -> Dict[str, torch.Tensor]:
    """The run's weights: the reference's names and shapes (which are the
    program's), drawn from the seed on ``device``. ``calibrate``: the eval
    block's BatchNorm running statistics set by the f32 reference's batch
    statistics on a calibration scene from the seed, at half the block's
    height and width (``ref.calibrate_bn``)."""
    with torch.device("meta"):
        template = ref.build(config["model"]).state_dict()
    weights = inputs.weights(template, seed, device)
    if not calibrate:
        return weights
    b = config["eval"]
    h, w = (max(64, n // 2 // 64 * 64) for n in (b["height"], b["width"]))
    frames, cams, _ = inputs.scene_pool(seed, 1, b["views"], h, w, b["num_depth"],
                                        stream="calibration")[0]
    images, cms = ref.request_inputs(frames, cams)
    net = reference(config, weights, device)
    ref.calibrate_bn(net, images.to(device), cms.to(device), forward_kwargs(b))
    calibrated = {k: v.detach().clone() for k, v in net.state_dict().items()}
    del net
    if torch.device(device).type == "cuda":     # the program's peak is the run's to report
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return calibrated


def reference(config: Dict, weights: Dict[str, torch.Tensor], device,
              precision: str = "f32") -> ref.PointMVSNet:
    net = ref.build(config["model"], precision).to(device)
    net.load_state_dict(weights)
    return net


def reference_maps(net: ref.PointMVSNet, images: torch.Tensor, cams: torch.Tensor,
                   kwargs: Dict, observe=None) -> Dict[str, np.ndarray]:
    """The reference's eval outputs for one scene, on the host."""
    net.eval()
    with torch.no_grad():
        out = net(images, cams, observe=observe, **kwargs)
    return {k: v[0].float().cpu().numpy() for k, v in out.items()}


class EvalReference:
    """The f32 reference and the reference in the configuration's
    precision (the scale of ``check.map_numbers``), one scene at a time."""

    def __init__(self, config: Dict, weights: Dict[str, torch.Tensor], device):
        self.f32 = reference(config, weights, device)
        self.stated = reference(config, weights, device,
                                ref.PRECISION_OF[config["eval"]["dtype"]])
        self.kwargs = forward_kwargs(config["eval"])

    def maps(self, images, cams, observe=None):
        """→ (f32 maps, maps in the stated precision)."""
        return (reference_maps(self.f32, images, cams, self.kwargs, observe),
                reference_maps(self.stated, images, cams, self.kwargs))

    def steps(self, images, cams, answer: Dict[str, np.ndarray]):
        """→ (f32 flows, flows in the stated precision), each iteration
        started from ``answer``'s ``flowN_input``."""
        starts = [torch.from_numpy(answer[f"{f}_input"])[None].to(images.device)
                  for f in FLOWS if f"{f}_input" in answer]
        kwargs = dict(self.kwargs, flow_inputs=starts)
        return (reference_maps(self.f32, images, cams, kwargs),
                reference_maps(self.stated, images, cams, kwargs))


FOLLOW = 4      # distinct answers compared iteration by iteration (a reference run each)


def eval_numbers(ref: EvalReference, scene_tensors, answers: List[Tuple[int, Dict]],
                 pick: np.random.Generator, bits=None) -> Dict[str, float]:
    """The eval cells' comparison: every answer ``(scene, maps)`` against
    the references' maps for its scene (``check.map_numbers``), and
    ``FOLLOW`` of the distinct answers, drawn with ``pick``, iteration by
    iteration (``check.step_numbers``). The largest of each number.
    ``scene_tensors(j)`` → scene j's (images, cams) on the card."""
    refs = {j: ref.maps(*scene_tensors(j), bits) for j in sorted({j for j, _ in answers})}
    nums = [map_numbers(ans, *refs[j]) for j, ans in answers]
    distinct = {}
    for j, ans in answers:
        key = (j, *(hashlib.sha1(np.ascontiguousarray(ans[f"{f}_input"])).hexdigest()
                    for f in FLOWS if f"{f}_input" in ans))
        distinct.setdefault(key, (j, ans))
    chosen = list(distinct.values())
    if len(chosen) > FOLLOW:
        chosen = [chosen[i] for i in sorted(pick.choice(len(chosen), FOLLOW, replace=False))]
    nums += [step_numbers(ans, *ref.steps(*scene_tensors(j), ans)) for j, ans in chosen]
    return worst(nums)


class MaskBits:
    """``observe`` for the reference: the set bits of each eval kNN's
    selection mask, by grid (the masked max's work, for its bound)."""

    def __init__(self):
        self.bits: Dict[Tuple[int, int, int], list] = {}

    def __call__(self, grid, mask: torch.Tensor) -> None:
        m = mask.long() & 0xFFFFFFFF
        pop = sum(int(((m >> s) & 1).sum()) for s in range(32))
        self.bits.setdefault(tuple(grid), []).append(pop)

    def mean(self) -> Dict[Tuple[int, int, int], float]:
        return {g: float(np.mean(v)) for g, v in self.bits.items()}
