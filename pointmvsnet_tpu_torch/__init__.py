"""PyTorch / CUDA port of ``pointmvsnet_tpu`` for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference: each module here keeps
its counterpart's name and public layouts (images ``(B, V, H, W, 3)``,
cams ``(B, V, 2, 4, 4)``, point features ``(B, P, C)``), and the tests run
both on the same inputs. This package imports neither JAX nor anything of
``pointmvsnet_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU they raise instead of falling back. Under torchrun, ``"cuda"`` is
the card of the process's ``LOCAL_RANK``. On a CUDA tensor the two
kernels of the eval path (``ops/knn.py::window_knn_mask`` and
``ops/edge.py::masked_window_max``) launch hand-written CUDA C++ from
``csrc/``; on a CPU tensor they run their plain PyTorch versions.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """``device`` → ``torch.device``; raise if CUDA is asked for and absent
    (no silent CPU fallback). A bare ``"cuda"`` is ``cuda:LOCAL_RANK``
    where torchrun set ``LOCAL_RANK`` (one card per rank), and becomes the
    current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev
