"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for sm_90a into ``_build/<name>-<hash>.so``, then loaded with ``ctypes``.
The hash covers the source, the device code the sources share
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt at its next
use; nothing is built at import. Pointers and the stream go in as
``c_void_p``; every entry returns ``cudaGetLastError()`` and ``check``
raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SMEM_PER_BLOCK = 232_448     # shared memory a block may use on an H100 (227 KB)
SMEM_PER_SM = 233_472        # an SM's (228 KB); each resident block reserves 1 KB of it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
              f"-DSMEM_PER_BLOCK={SMEM_PER_BLOCK}")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry → argtypes (pointers and the stream as c_void_p, sizes as c_int)
SIGNATURES = {
    "window_knn": {"window_knn": [_P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "window_knn_general": {
        "window_knn_general": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "masked_window_max": {
        "masked_window_max": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "window_gather": {"window_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "point_fetch": {
        "point_fetch": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "plane_sweep": {
        "plane_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}     # nvcc output (ptxas register/spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every listed kernel whose library is missing, one ``nvcc``
    per source, all started together. Raises with nvcc's output on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
