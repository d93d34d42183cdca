"""yacs-compatible configuration: the port's own copy of
``pointmvsnet_tpu/config.py`` (``CfgNode``, the default schema, YAML
overlay, dotted-path CLI merge).

The schema is the JAX package's, key for key, so its YAML files and CLI
overrides load unchanged. ``yaml`` is imported only by the functions that
read or write YAML: on a machine without it, build the config in code.
Keys that only steer the TPU build (``KNN_IMPL``, ``FLOW_FETCH``,
``COARSE_FETCH``, ``FLOW_MOMENTS``, ``FLOW_SRC_DTYPE``, ``REMAT*``,
``FLOW_CHUNK_ROWS``, ``PARALLEL.*``) stay in the schema for that reason;
``models.build_model`` rejects the model knobs among them when they differ
from their defaults.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

_VALID_TYPES = (int, float, bool, str, list, tuple, type(None))


class CfgNode(dict):
    """A dict with attribute access, freezing, and recursive merge.

    API-compatible subset of ``yacs.config.CfgNode`` as used by the
    reference: attribute get/set, ``merge_from_file``, ``merge_from_list``,
    ``freeze``, ``defrost``, ``clone``, ``dump``.
    """

    _FROZEN = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"Cannot set {name!r}: CfgNode is frozen")
        if not isinstance(value, _VALID_TYPES + (CfgNode, dict)):
            raise TypeError(f"Invalid config value type for {name!r}: {type(value)}")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"Cannot set {name!r}: CfgNode is frozen")
        super().__setitem__(name, value)

    # -- freeze / clone ---------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merge ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, filename: str) -> None:
        import yaml
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f) or {}
        _merge_a_into_b(CfgNode(loaded), self)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge dotted-path CLI overrides, e.g. ``["TRAIN.BATCH_SIZE", 4]``."""
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be key/value pairs, got odd length {len(opts)}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config section: {key!r}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key!r}")
            node[leaf] = _coerce(value, node[leaf], key)

    def dump(self) -> str:
        import yaml
        return yaml.safe_dump(_to_dict(self), sort_keys=True)


def _to_dict(node: CfgNode) -> Dict[str, Any]:
    return {k: _to_dict(v) if isinstance(v, CfgNode) else (list(v) if isinstance(v, tuple) else v) for k, v in node.items()}


def _merge_a_into_b(a: CfgNode, b: CfgNode) -> None:
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"Non-existent config key: {k!r}")
        if isinstance(v, (CfgNode, dict)):
            if not isinstance(b[k], CfgNode):
                raise TypeError(f"Cannot merge section into leaf at {k!r}")
            _merge_a_into_b(CfgNode(v) if not isinstance(v, CfgNode) else v, b[k])
        else:
            b[k] = _coerce(v, b[k], k)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce ``value`` (possibly a CLI string) to the type of ``old``."""
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if type(value) == type(old) or old is None or value is None:
        return value
    if isinstance(value, str):
        if isinstance(old, bool):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
            raise ValueError(f"Cannot coerce {value!r} to bool for key {key!r}")
        if isinstance(old, int):
            return int(value)
        if isinstance(old, float):
            return float(value)
        if isinstance(old, (list, tuple)):
            # "(0.25, 0.5)" (python literal, what yacs accepts) or
            # "[0.25, 0.5]" (yaml). yaml.safe_load returns paren strings
            # unchanged, and tuple(<str>) would explode into characters.
            try:
                parsed = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                import yaml
                parsed = yaml.safe_load(value)
            if not isinstance(parsed, (list, tuple)):
                raise ValueError(
                    f"Cannot parse {value!r} as a sequence for key {key!r}")
            return tuple(parsed) if isinstance(old, tuple) else list(parsed)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, int) and isinstance(value, float) and value == int(value):
        return int(value)
    raise TypeError(f"Type mismatch for key {key!r}: {type(value)} vs {type(old)}")


# ---------------------------------------------------------------------------
# Default schema (reconstruction of reference `pointmvsnet/config.py :: _C`)
# ---------------------------------------------------------------------------

def get_default_cfg() -> CfgNode:
    _C = CfgNode()

    _C.OUTPUT_DIR = "@"  # "@" → auto: outputs/<config-stem> (reference convention)
    _C.RNG_SEED = 1
    _C.LOG_PERIOD = 10
    _C.VAL_PERIOD = 1
    _C.AUTO_RESUME = True

    # -- data ------------------------------------------------------------
    _C.DATA = CfgNode()
    _C.DATA.NUM_WORKERS = 1
    _C.DATA.TRAIN = CfgNode()
    _C.DATA.TRAIN.ROOT_DIR = "data/dtu"
    _C.DATA.TRAIN.NUM_VIEW = 3
    _C.DATA.TRAIN.NUM_VIRTUAL_PLANE = 48
    _C.DATA.TRAIN.INTERVAL_SCALE = 1.06
    _C.DATA.VAL = CfgNode()
    _C.DATA.VAL.ROOT_DIR = "data/dtu"
    _C.DATA.VAL.NUM_VIEW = 3
    _C.DATA.TEST = CfgNode()
    _C.DATA.TEST.ROOT_DIR = "data/dtu"
    _C.DATA.TEST.NUM_VIEW = 5
    _C.DATA.TEST.NUM_VIRTUAL_PLANE = 96
    _C.DATA.TEST.INTERVAL_SCALE = 0.8
    _C.DATA.TEST.IMG_HEIGHT = 512
    _C.DATA.TEST.IMG_WIDTH = 640
    _C.DATA.TEST.DATASET = "dtu"  # "dtu" | "tanks" (Tanks & Temples, MVSNet cam format)
    _C.DATA.TEST.RESCALE_DEPTH = True  # tanks: honor each cam file's own
                                       # num_depth by stretching the interval
                                       # so the static NUM_VIRTUAL_PLANE spans
                                       # the file's full depth range
    _C.DATA.TEST.SHAPE_SET = ()   # tanks: optional ((H, W), ...) candidates;
                                  # each scene picks the best fit (ragged
                                  # resolutions → one compile per shape)

    # -- model -----------------------------------------------------------
    _C.MODEL = CfgNode()
    _C.MODEL.NAME = "pointmvsnet"           # registry key (framework addition)
    _C.MODEL.NORM = "bn"                     # "bn" (reference nn/) | "gn" (reference nn_gn/)
    _C.MODEL.IMG_BASE_CHANNELS = 8           # ImageConv base channels
    _C.MODEL.VOL_BASE_CHANNELS = 8           # VolumeConv base channels
    _C.MODEL.FLOW_CHANNELS = (64, 64, 16, 1)  # PointFlow MLP head channels
    _C.MODEL.EDGE_CHANNELS = (32, 32, 64)    # EdgeConv stack output channels
    _C.MODEL.NUM_VIRTUAL_PLANE = 48          # D, coarse depth hypotheses (train)
    _C.MODEL.VALID_THRESHOLD = 2.0           # mask: |d - gt| < thr * interval counts valid
    _C.MODEL.FLOW_INTERVAL_M = 2             # m → 2m+1 hypothesis points per pixel
    _C.MODEL.KNN = 16                        # k for EdgeConv neighborhoods
    _C.MODEL.KNN_WINDOW = 5                  # spatial window for windowed 3D kNN
    _C.MODEL.MASKED_LOSS = True
    _C.MODEL.TRAIN = CfgNode()
    _C.MODEL.TRAIN.IMG_SCALES = (0.25, 0.5)   # scales at which flow iters run
    _C.MODEL.TRAIN.INTER_SCALES = (0.75, 0.375)  # flow displacement step, in depth-interval units
    _C.MODEL.TEST = CfgNode()
    _C.MODEL.TEST.IMG_SCALES = (0.25, 0.5, 1.0)
    _C.MODEL.TEST.INTER_SCALES = (0.75, 0.375, 0.1875)
    # CasMVSNet (MODEL.NAME casmvsnet; the port's addition): per stage, at
    # 1/4, 1/2 and 1/1 of the image, the depth hypotheses and their
    # spacing in units of (base depth range) / DATA.TEST.NUM_VIRTUAL_PLANE
    _C.MODEL.CASCADE = CfgNode()
    _C.MODEL.CASCADE.NDEPTHS = (48, 32, 8)
    _C.MODEL.CASCADE.DEPTH_INTERVAL_RATIOS = (4.0, 2.0, 1.0)

    # Additions of the JAX package (no reference counterpart). Only DTYPE
    # steers the port; the others select TPU engines and must keep their
    # defaults here (models.build_model raises otherwise).
    _C.MODEL.DTYPE = "float32"               # compute dtype: "float32" | "bfloat16"
    _C.MODEL.KNN_IMPL = "auto"               # "auto" | "xla" | "pallas"
    _C.MODEL.FLOW_CHUNK_ROWS = -1            # flow band height (-1 auto, 0 none)
    _C.MODEL.REMAT = False                   # rematerialize the flow stages
    _C.MODEL.REMAT_SAVE = ("knn", "feat")    # values the remat policy saves
    _C.MODEL.FLOW_FETCH = "auto"             # "table" | "bilinear" | "auto"
    _C.MODEL.COARSE_FETCH = "mxu"            # plane-sweep gather: "mxu" | "take"
    _C.MODEL.FLOW_MOMENTS = "auto"           # "on" | "off" | "auto" (= on)
    _C.MODEL.FLOW_SRC_DTYPE = ""             # per-view source dtype ("" = f32)

    # -- solver (reference `pointmvsnet/utils/solver.py`) ----------------
    _C.SOLVER = CfgNode()
    _C.SOLVER.TYPE = "RMSprop"
    _C.SOLVER.BASE_LR = 0.0005
    _C.SOLVER.WEIGHT_DECAY = 0.001
    _C.SOLVER.RMSPROP = CfgNode()
    _C.SOLVER.RMSPROP.ALPHA = 0.9
    _C.SOLVER.RMSPROP.EPS = 1e-8
    _C.SOLVER.SKIP_NONFINITE = True          # skip (not apply) updates when
                                             # grads are non-finite

    _C.SCHEDULER = CfgNode()
    _C.SCHEDULER.TYPE = "StepLR"
    _C.SCHEDULER.INIT_EPOCH = 4              # coarse-only curriculum length
    _C.SCHEDULER.MAX_EPOCH = 16
    _C.SCHEDULER.STEP_LR = CfgNode()
    _C.SCHEDULER.STEP_LR.STEP_SIZE = 2
    _C.SCHEDULER.STEP_LR.GAMMA = 0.9

    # -- train / test loops ----------------------------------------------
    _C.TRAIN = CfgNode()
    _C.TRAIN.BATCH_SIZE = 4
    _C.TRAIN.CHECKPOINT_PERIOD = 1
    _C.TRAIN.LOG_PERIOD = 10
    _C.TRAIN.VAL_PERIOD = 1
    _C.TRAIN.FROZEN_PATTERNS = ()            # reference `nn/freezer.py :: Freezer`

    _C.TEST = CfgNode()
    _C.TEST.BATCH_SIZE = 1
    _C.TEST.WEIGHT = ""
    _C.TEST.LOG_PERIOD = 10

    # -- parallelism of the JAX package (the port runs one device) --------
    _C.PARALLEL = CfgNode()
    _C.PARALLEL.DATA = -1
    _C.PARALLEL.VIEW = 1
    _C.PARALLEL.BAND = 1

    return _C


def load_cfg_from_file(filename: str) -> CfgNode:
    """Load defaults then overlay a YAML file (reference
    ``pointmvsnet/config.py :: load_cfg_from_file``)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(filename)
    return cfg
