"""The port's C++ host data plane: ``src/dataplane.cpp`` bound with ctypes.

PFM and MVSNet cam.txt reading, a threaded batch PFM reader, per-channel
standardisation and a nearest resize, with the names and signatures of
``pointmvsnet_tpu/native`` and its results bit for bit. ``dataset/io.py``
reads PFMs and cameras through it unless ``PMVS_NO_NATIVE`` is set.

The library is built with ``g++`` at first use into
``_build/dataplane-<hash>.so``; the hash covers the source, the flags, the
compiler's version and the machine, so a changed one is rebuilt. Each
build writes a file of its own and moves it into place, so processes that
build at once end with one library. A failed build raises
``RuntimeError`` with the compiler's output; nothing is built at import.
ctypes releases the GIL for each call, so loader threads read in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# no -march=native: a library built for one host's instructions can reach
# another through a copied tree; no FMA contraction (see dataplane.cpp)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
LDLIBS = ("-lpthread",)

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C")
_I, _PI = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "pfm_shape": [ctypes.c_char_p, _PI, _PI, _PI],
    "pfm_load": [ctypes.c_char_p, _F32, ctypes.c_int64],
    "pfm_load_batch": [ctypes.c_char_p, _I, ctypes.c_int64, _F32, _I],
    "cam_load": [ctypes.c_char_p, _F32, ctypes.c_double, _I],
    "image_standardize": [_F32, ctypes.c_int64, _I],
    "resize_nearest": [_F32, _I, _I, _F32, _I, _I, _I],
}

# files read by the C path, by kind (as ``ops.knn.launches`` counts launches)
loads: Dict[str, int] = {"pfm": 0, "cam": 0}

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: str) -> str:
    try:
        out = subprocess.run([cxx, "-dumpfullversion"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"the C++ data plane needs a compiler: {cxx}: {e}") from e
    return out.stdout.strip()


def compiler_version() -> str:
    """``CXX -dumpfullversion``; raises RuntimeError without a compiler."""
    return _compiler_version(CXX)


def lib_path() -> Path:
    key = b"\0".join([SRC.read_bytes(), " ".join(CXX_FLAGS + LDLIBS).encode(),
                      compiler_version().encode(), platform.machine().encode()])
    return BUILD_DIR / f"dataplane-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``src/dataplane.cpp`` unless its library is built; → the
    library's path. Raises RuntimeError with the compiler's output."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LDLIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the C++ data plane: {' '.join(cmd)}: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the C++ data plane: {' '.join(cmd)} exited "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out


def load() -> ctypes.CDLL:
    """The library, built on first use; raises RuntimeError if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    global _build_error
    try:
        load()
    except RuntimeError as e:
        _build_error = str(e)
        return False
    _build_error = None
    return True


def build_error() -> Optional[str]:
    """Why the library could not be built, or None."""
    available()
    return _build_error


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {what} failed with code {rc}")


def _count(kind: str, n: int) -> None:
    with _lock:
        loads[kind] += n


def load_pfm(path: str) -> np.ndarray:
    """A PFM → float32 (H, W) or (H, W, 3), rows top-down."""
    lib = load()
    p = os.fsencode(path)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.pfm_shape(p, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)),
           f"pfm_shape({path})")
    out = np.empty((h.value, w.value) if c.value == 1 else (h.value, w.value, c.value),
                   np.float32)
    _check(lib.pfm_load(p, out.reshape(-1), out.size), f"pfm_load({path})")
    _count("pfm", 1)
    return out


def load_pfm_batch(paths: Sequence[str], height: int, width: int, channels: int = 1,
                   n_threads: int = 0) -> np.ndarray:
    """PFMs of one shape, read by ``n_threads`` threads (0: one per hardware
    thread) → (N, H, W[, C]) float32."""
    lib = load()
    n, plane = len(paths), height * width * channels
    out = np.empty((n, plane), np.float32)
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    _check(lib.pfm_load_batch(blob, n, plane, out, n_threads), "pfm_load_batch")
    _count("pfm", n)
    return out.reshape((n, height, width) if channels == 1 else (n, height, width, channels))


def load_cam(path: str, interval_scale: float = 1.0, num_depth: int = 0) -> np.ndarray:
    """An MVSNet cam.txt → (2, 4, 4) float32; ``num_depth`` > 0 fills in the
    count and depth_max where the depth line has fewer than 4 numbers."""
    lib = load()
    out = np.empty(32, np.float32)
    _check(lib.cam_load(os.fsencode(path), out, float(interval_scale), int(num_depth)),
           f"cam_load({path})")
    _count("cam", 1)
    return out.reshape(2, 4, 4)


def _image(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim not in (2, 3):
        raise ValueError(f"want an (H, W) or (H, W, C) image, got shape {img.shape}")
    return img


def standardize(img: np.ndarray) -> np.ndarray:
    """Per-channel (x − mean) / (std + 1e-7) of (H, W[, C]) float32, in place
    where ``img`` is already C-contiguous float32."""
    lib = load()
    img = _image(img)
    h, w = img.shape[:2]
    _check(lib.image_standardize(img.reshape(-1), h * w, img.shape[2] if img.ndim == 3 else 1),
           "standardize")
    return img


def resize_nearest(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W[, C]) float32 → (dh, dw[, C]): source index y·H // dh, x·W // dw."""
    lib = load()
    img = _image(img)
    sh, sw = img.shape[:2]
    if dh and dw and not (sh and sw):
        raise ValueError(f"cannot resize an empty {img.shape} image to {dh}x{dw}")
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((dh, dw, c) if img.ndim == 3 else (dh, dw), np.float32)
    _check(lib.resize_nearest(img.reshape(-1), sh, sw, out.reshape(-1), dh, dw, c),
           "resize_nearest")
    return out

