"""The port's C++ host data plane: ``src/dataplane.cpp`` and
``src/image.cpp``, one library bound with ctypes.

``dataplane.cpp``: PFM and MVSNet cam.txt reading, a threaded batch PFM
reader, per-channel standardisation and a nearest resize, with the names
and signatures of ``pointmvsnet_tpu/native`` and its results bit for bit.
``image.cpp``: the hot parts of the port's image readers (a baseline JPEG
scan's entropy decode, JPEG reconstruction, the PNG row unfilter) and the
linear resize, bit-equal to the Python and numpy versions in ``dataset/``,
whose exceptions the wrappers here raise. ``dataset/io.py``,
``dataset/jpeg.py`` and ``dataset/preprocess.py`` go through it unless
``PMVS_NO_NATIVE`` is set.

The library is built with ``g++`` at first use into
``_build/dataplane-<hash>.so``; the hash covers the sources, the flags, the
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
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SRCS = tuple(Path(__file__).resolve().parent / "src" / f for f in ("dataplane.cpp", "image.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# no -march=native: a library built for one host's instructions can reach
# another through a copied tree; no FMA contraction (see dataplane.cpp and
# resize_linear in image.cpp)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
LDLIBS = ("-lpthread",)

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
_I16 = np.ctypeslib.ndpointer(np.int16, flags="C")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_I64A = np.ctypeslib.ndpointer(np.int64, flags="C")
_I, _I64, _PI = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
_PI64, _P = ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p
_SIGNATURES = {
    "pfm_shape": [ctypes.c_char_p, _PI, _PI, _PI],
    "pfm_load": [ctypes.c_char_p, _F32, ctypes.c_int64],
    "pfm_load_batch": [ctypes.c_char_p, _I, ctypes.c_int64, _F32, _I],
    "cam_load": [ctypes.c_char_p, _F32, ctypes.c_double, _I],
    "image_standardize": [_F32, ctypes.c_int64, _I],
    "resize_nearest": [_F32, _I, _I, _F32, _I, _I, _I],
    "jpeg_scan": [ctypes.c_char_p, _I64, _I64, _I64, _I, _I32, _I64A, _I64, _U8, _I64, _I64A,
                  _I, _I32, _I32, _I, _I16, _I64, _PI64, _PI64],
    "jpeg_reconstruct": [_I16, _I64, _I, _I32, _I32, _I, _I, _I, _U8],
    "png_unfilter": [_U8, _I64, _I64, _I, _U8],
    "resize_linear": [_P, _I, _I64, _I64, _I64, _P, _I, _I64, _I64, _I64A, _I64A, _F32, _F32,
                      _I64A, _I64A, _F32, _F32],
}

# files read (pfm, cam; jpeg: decoded images, png: unfiltered images) and
# images resized by the C path, by kind (as ``ops.knn.launches`` counts
# launches)
loads: Dict[str, int] = {"pfm": 0, "cam": 0, "jpeg": 0, "png": 0, "resize": 0}

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
    key = b"\0".join([*(src.read_bytes() for src in SRCS),
                      " ".join(CXX_FLAGS + LDLIBS).encode(), compiler_version().encode(),
                      platform.machine().encode()])
    return BUILD_DIR / f"dataplane-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``src/*.cpp`` unless their library is built; → the
    library's path. Raises RuntimeError with the compiler's output."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *map(str, SRCS), *LDLIBS]
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


# jpeg_scan's return codes → the exception the Python decoder
# (dataset/jpeg.py) raises at that point
_SCAN_ERRORS = {
    -1: "JPEG scan runs to the end of the file (no EOI)",
    -2: "corrupt JPEG entropy-coded data: cannot unpack non-iterable NoneType object",
    -3: "corrupt JPEG entropy-coded data: array index out of range",
    -4: "JPEG scan has fewer restart intervals than MCUs need",
    -5: "JPEG block has more than 64 coefficients",
}


def jpeg_scan(data: bytes, start: int, n_mcu: int, restart: int, slots: np.ndarray,
              offsets: np.ndarray, specs: Sequence[Tuple[bytes, bytes]], dc_tab: np.ndarray,
              ac_tab: np.ndarray, coefs: np.ndarray) -> int:
    """Decode the baseline scan whose entropy-coded data starts at
    ``data[start]`` into ``coefs`` (int16, zigzag within each block) → the
    offset of the marker that ends it. ``slots`` / ``offsets``: scan
    component and first coefficient of each block in stream order
    (``jpeg._scan_layout``); ``specs``: Huffman tables as (BITS, values);
    ``dc_tab`` / ``ac_tab``: each scan component's table in ``specs``.
    Raises the ValueError or IndexError of the Python decoder."""
    lib = load()
    blob = np.frombuffer(b"".join(b + v for b, v in specs), np.uint8)
    spec_off = np.cumsum([0] + [len(b) + len(v) for b, v in specs[:-1]], dtype=np.int64)
    end, err = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.jpeg_scan(bytes(data), len(data), start, n_mcu, restart,
                       np.ascontiguousarray(slots, np.int32),
                       np.ascontiguousarray(offsets, np.int64), len(slots), blob, blob.size,
                       spec_off, len(specs), np.ascontiguousarray(dc_tab, np.int32),
                       np.ascontiguousarray(ac_tab, np.int32), len(dc_tab), coefs, coefs.size,
                       ctypes.byref(end), ctypes.byref(err))
    if rc in _SCAN_ERRORS:
        raise ValueError(_SCAN_ERRORS[rc])
    if rc == -6:
        raise IndexError(f"index {err.value} is out of bounds for axis 0 with size {coefs.size}")
    _check(rc, "jpeg_scan")
    return end.value


def jpeg_reconstruct(coefs: np.ndarray, comps: np.ndarray, qt: np.ndarray, height: int,
                     width: int, mode: int) -> np.ndarray:
    """Coefficients (int16, zigzag within each block) → (height, width, 3)
    uint8 RGB. ``comps``: per component (first block, block grid width and
    height, downsampled width and height, upsampling factors h and v);
    ``qt``: its quantisation table, natural order; ``mode``: 0 grey, 1
    RGB, 2 YCbCr."""
    lib = load()
    out = np.empty((height, width, 3), np.uint8)
    _check(lib.jpeg_reconstruct(coefs, coefs.size, len(comps),
                                np.ascontiguousarray(comps, np.int32),
                                np.ascontiguousarray(qt, np.int32), height, width, mode,
                                out.reshape(-1)), "jpeg_reconstruct")
    _count("jpeg", 1)
    return out


def png_unfilter(rows: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """(height, 1 + width·bpp) uint8 PNG rows, each its filter type and its
    filtered bytes → (height, width, bpp) uint8. A filter type above 4
    raises ValueError, as ``io._unfilter`` does."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.shape != (height, 1 + width * bpp):
        raise ValueError(f"PNG rows of shape {rows.shape}, want ({height}, {1 + width * bpp})")
    out = np.empty((height, width, bpp), np.uint8)
    rc = lib.png_unfilter(rows.reshape(-1), height, width, bpp, out.reshape(-1))
    if rc == -1:
        raise ValueError(f"unknown PNG filter type {int(rows[:, 0].max())}")
    _check(rc, f"png_unfilter(bpp={bpp})")
    _count("png", 1)
    return out


def resize_linear(img: np.ndarray, taps_y, taps_x) -> np.ndarray:
    """(H, W, ...) → (len(y0), len(x0), ...) through two taps per axis,
    ``taps_*`` = (i0, i1, weight of i0, weight of i1) as
    ``preprocess._linear_taps`` gives them: rows first, then columns, in
    float32. uint8 in gives uint8 out (rounded half up, clipped), any other
    dtype float32."""
    lib = load()
    u8 = img.dtype == np.uint8
    x = np.ascontiguousarray(img, np.uint8 if u8 else np.float32)
    (y0, y1, ay0, ay1), (x0, x1, ax0, ax1) = taps_y, taps_x
    out = np.empty((len(y0), len(x0)) + x.shape[2:], x.dtype)
    _check(lib.resize_linear(x.ctypes.data, int(u8), x.shape[0], x.shape[1],
                             int(np.prod(x.shape[2:])), out.ctypes.data, int(u8), len(y0),
                             len(x0), x0, x1, ax0, ax1, y0, y1, ay0, ay1), "resize_linear")
    _count("resize", 1)
    return out
