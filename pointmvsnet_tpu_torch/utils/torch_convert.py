"""Reference Point-MVSNet ``.pth`` → the port's ``state_dict``: counterpart
of ``pointmvsnet_tpu/utils/torch_convert.py``.

    python -m pointmvsnet_tpu_torch.utils.torch_convert --pth model.pth \\
        --cfg configs/dtu_wde3.yaml --out weights.pt
    python -m pointmvsnet_tpu_torch.test --cfg configs/dtu_wde3.yaml TEST.WEIGHT weights.pt ...

The reference's module names are not known, so, as in the JAX package,
the match is structural: the port's tensors are visited in the order the
JAX package's converter visits its flax leaves (the natural sort of their
flax paths, ``utils/convert.py::_MODULES`` read backwards: ``batch_stats``
before ``params``, ``BatchNorm_0`` before ``Conv_0``, ``ConvBlock_10``
after ``ConvBlock_2``), and each takes the first unused reference tensor,
in the ``.pth``'s order, whose name ends in the right leaf name and whose
converted shape is the target's. That order decides which of several
tensors of one shape goes where, so the assignment is the one the JAX
package makes, carried across by ``utils/convert.py::jax_to_torch``. The
port keeps torch's layouts, so most conversions are the identity: only
the flow head's ``(O, I, 1)`` Conv1d kernels become ``(O, I)`` Linear
weights and EdgeConv's ``(F, 2C, 1, 1)`` Conv2d becomes its ``(2C, F)``
kernel. A ``name_map`` (port key → reference tensor name) pins tensors by
name instead.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pointmvsnet_tpu_torch.utils.convert import _MODULES

# port leaf → flax collection / leaf ("weight" and EdgeConv's "kernel" are
# "kernel" in a conv or dense module and "scale" in a norm); the reference's
# leaf name is the port's, or "weight" for those two
_FLAX_LEAF = {"running_mean": "batch_stats/mean", "running_var": "batch_stats/var",
              "bias": "params/bias"}


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint → ``{name: ndarray}``: the ``model`` or
    ``state_dict`` entry if there is one, without an ``nn.DataParallel``
    ``module.`` prefix. Unpickles with ``weights_only=False``, as the
    reference's files need: load only files from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v.detach().cpu().numpy() for k, v in obj.items()}


def flax_path(key: str, model: torch.nn.Module) -> Tuple[str, Optional[str]]:
    """A key of the port's ``state_dict`` → (the JAX package's flax path,
    kernel kind or None): ``utils/convert.py::torch_name`` inverted."""
    module, leaf = key.rsplit(".", 1)
    for pat, repl, kind in _MODULES:
        m = re.fullmatch(re.escape(repl).replace(r"\{0\}", r"(\d+)"), module)
        if m:
            norm = ("GroupNorm" if isinstance(model.get_submodule(module), torch.nn.GroupNorm)
                    else "BatchNorm")
            flax = pat.replace(r"(\d+)", m.group(1)).replace("(?:BatchNorm|GroupNorm)", norm)
            if leaf in _FLAX_LEAF:
                return f"{_FLAX_LEAF[leaf].replace('/', f'/{flax}/')}", None
            if leaf in ("weight", "kernel"):
                return (f"params/{flax}/kernel", kind) if kind else (f"params/{flax}/scale", None)
            break
    raise KeyError(f"no flax counterpart for {key!r}")


def _natural(path: str):
    # "ConvBlock_10" sorts after "ConvBlock_2": numeric runs compare as numbers
    return tuple(tuple(int(t) if t.isdigit() else t for t in re.split(r"(\d+)", p))
                 for p in path.split("/"))


def convert_leaf(kind: Optional[str], w: np.ndarray) -> np.ndarray:
    """A reference tensor → the port's layout for a kernel of ``kind``
    (``utils/convert.py::_MODULES``); raises ``ValueError`` where the JAX
    package's converter cannot convert it either."""
    if kind in ("dense", "edge"):
        if kind == "edge" and w.ndim >= 4 and (w.ndim > 5 or np.squeeze(w).ndim != 2):
            raise ValueError(f"not a 1x1 conv kernel: shape {w.shape}")
        while w.ndim > 2 and w.shape[-1] == 1:      # keep a 1-wide out-channel dim
            w = w[..., 0]
        if w.ndim != 2:
            raise ValueError(f"not a linear kernel: shape {w.shape}")
        w = w.T if kind == "edge" else w               # EdgeConv keeps flax's (2C, F)
    elif kind == "conv" and w.ndim not in (4, 5):
        raise ValueError(f"not a conv kernel: shape {w.shape}")
    return np.ascontiguousarray(w, np.float32)


def convert_state_dict(torch_sd: Mapping[str, np.ndarray], model: torch.nn.Module,
                       name_map: Optional[Mapping[str, str]] = None) -> Dict[str, torch.Tensor]:
    """Reference tensors → every parameter and BatchNorm statistic of
    ``model``'s ``state_dict`` (``num_batches_tracked`` excepted), matched
    as the module docstring says. ``name_map``: port key → reference name,
    tried first. Raises if any port tensor stays unmatched."""
    name_map = dict(name_map or {})
    remaining = {k: np.asarray(v) for k, v in torch_sd.items()
                 if np.asarray(v).dtype != np.int64}  # num_batches_tracked
    targets = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    paths = {k: flax_path(k, model) for k in targets}
    out, unmatched = {}, []
    for key in sorted(targets, key=lambda k: _natural(paths[k][0])):
        kind, shape = paths[key][1], tuple(targets[key].shape)
        leaf = key.rsplit(".", 1)[-1]
        ref_leaf = leaf if leaf in _FLAX_LEAF else "weight"
        if key in name_map:
            name = name_map[key]
            if name not in remaining:
                raise KeyError(f"name_map points at missing torch tensor {name!r}")
            w = convert_leaf(kind, remaining.pop(name))
            if w.shape != shape:
                raise ValueError(f"converted shape {w.shape} != target {shape} at {key}")
            out[key] = torch.from_numpy(w)
            continue
        for name, w in remaining.items():
            if not (name == ref_leaf or name.endswith("." + ref_leaf)):
                continue
            try:
                w = convert_leaf(kind, w)
            except ValueError:
                continue
            if w.shape == shape:
                out[key] = torch.from_numpy(w)
                del remaining[name]
                break
        else:
            unmatched.append(f"{key} ({paths[key][0]})")
    if unmatched:
        raise ValueError(f"unmatched port tensors ({len(unmatched)}): {unmatched[:8]} ...")
    return out


def convert_checkpoint(pth_path: str, cfg, out_path: str,
                       name_map: Optional[Mapping[str, str]] = None) -> str:
    """Reference ``.pth`` → a ``.pt`` holding ``{"model": state_dict}``
    for ``cfg``'s model, which ``TEST.WEIGHT`` and
    ``Predictor(weight_path=)`` read. No forward pass: the shapes come
    from the model built on the CPU. → ``out_path``."""
    from pointmvsnet_tpu_torch.models import build_model

    model = build_model(cfg, "cpu")
    sd = model.state_dict()
    sd.update(convert_state_dict(load_pth(pth_path), model, name_map))
    torch.save({"model": sd}, out_path)
    return out_path


def main(argv=None):
    from pointmvsnet_tpu_torch.config import get_default_cfg

    p = argparse.ArgumentParser(description="reference Point-MVSNet .pth -> TEST.WEIGHT .pt")
    p.add_argument("--pth", required=True)
    p.add_argument("--cfg", required=True, help="config YAML of the model (needs PyYAML)")
    p.add_argument("--out", required=True, help="the .pt to write")
    args = p.parse_args(argv)
    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    cfg.freeze()
    print(f"converted {args.pth} -> {convert_checkpoint(args.pth, cfg, args.out)}")


if __name__ == "__main__":
    main()
