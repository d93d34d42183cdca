"""Parameter freezing by name pattern: counterpart of
``pointmvsnet_tpu/utils/freezer.py``. A parameter whose name any regex of
``TRAIN.FROZEN_PATTERNS`` finds (``re.search``) gets no update and no
weight decay. The port matches its own parameter names
(``img_conv.blocks.0.conv.weight``), the JAX package its flax paths
(``img_conv/ConvBlock_0/Conv_0/kernel``); a pattern that names a top-level
module (``img_conv``, ``vol_conv``, ``point_flow``) means the same in both.
BatchNorm running statistics are not parameters and still blend in
training mode, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence, Set


def frozen_names(names: Iterable[str], patterns: Sequence[str]) -> Set[str]:
    """The names that any of ``patterns`` finds."""
    pats = [re.compile(p) for p in patterns]
    return {n for n in names if any(p.search(n) for p in pats)}
