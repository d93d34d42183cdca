"""MVSNet-format file I/O and images: the port's copy of
``pointmvsnet_tpu/dataset/io.py`` (PFM, cam.txt, pair.txt; PFMs and
cameras read through the port's C++ data plane, ``native/``, unless
``PMVS_NO_NATIVE`` is set, with the Python readers ``_load_pfm_py`` /
``_load_cam_py`` beside it, bit-equal) plus ``read_png`` /
``write_png``, ``read_jpeg`` / ``write_jpeg`` (``dataset/jpeg.py``) and
``read_image``, which take the place of the JAX package's ``cv2.imread`` /
``cv2.imwrite``. PNG rows are unfiltered by the C++ library too (Python:
``_unfilter``); inflate is ``zlib``'s.

cam.txt::

    extrinsic
    <4x4 world-to-camera matrix, row-major, 4 lines>
    (blank)
    intrinsic
    <3x3 K matrix, 3 lines>
    (blank)
    DEPTH_MIN DEPTH_INTERVAL [NUM_DEPTH DEPTH_MAX]

In memory a camera is (2, 4, 4): ``cam[0]`` the extrinsic, ``cam[1, :3, :3]``
K, ``cam[1, 3] = (depth_min, depth_interval, num_depth, depth_max)``.

PFM: header ``Pf`` (1 channel) / ``PF`` (3 channels), ``width height``,
a scale whose sign gives the byte order, rows stored bottom-up.

PNG: 8-bit greyscale, grey + alpha, RGB and RGBA images, not interlaced,
with any of the five row filters. ``read_png`` returns RGB as
``cv2.imread(IMREAD_COLOR)`` followed by a BGR→RGB swap would: grey
replicated, alpha dropped.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pointmvsnet_tpu_torch.dataset.jpeg import read_jpeg, write_jpeg  # noqa: F401

# ---------------------------------------------------------------------------
# The C++ data plane
# ---------------------------------------------------------------------------

_NATIVE = None


def _native():
    """The C++ data plane (``pointmvsnet_tpu_torch.native``), built on first
    use, or False where ``PMVS_NO_NATIVE`` is set. A failed build raises:
    unlike the JAX package, which then reads in Python, only the variable
    selects the Python readers (and the Python JPEG decoder, PNG unfilter
    and linear resize)."""
    global _NATIVE
    if _NATIVE is None:
        if os.environ.get("PMVS_NO_NATIVE"):
            _NATIVE = False
        else:
            from pointmvsnet_tpu_torch import native
            native.load()
            _NATIVE = native
    return _NATIVE


def reset_native() -> None:
    """Choose again at the next read (after ``PMVS_NO_NATIVE`` changed)."""
    global _NATIVE
    _NATIVE = None


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------


def load_pfm(path: str) -> np.ndarray:
    """Read a PFM file → float32 array (H, W) or (H, W, 3), top-down rows."""
    n = _native()
    if n:
        try:
            return n.load_pfm(path)
        except RuntimeError:
            pass  # the Python reader raises the precise exception
    return _load_pfm_py(path)


def _load_pfm_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"Not a PFM file: {path!r} (header {header!r})")
        dim_line = f.readline()
        while dim_line.startswith(b"#"):  # tolerate comment lines
            dim_line = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"Malformed PFM dimension line in {path!r}: {dim_line!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(width * height * channels * 4), dtype=endian + "f4")
    data = data.reshape(height, width, channels) if channels == 3 else data.reshape(height, width)
    data = np.flipud(data).astype(np.float32)          # PFM rows are bottom-up
    if scale not in (0.0, -1.0, 1.0):
        data = data * np.float32(abs(scale))
    return np.ascontiguousarray(data)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array (H, W) or (H, W, 1|3) as little-endian PFM with
    the header scale ``|scale|`` (negative on disk: little-endian); a reader
    multiplies the data by it unless it is 0 or 1."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    elif image.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"PFM supports (H,W) or (H,W,3); got {image.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        np.flipud(image).astype("<f4").tofile(f)


# ---------------------------------------------------------------------------
# Cameras and view pairs
# ---------------------------------------------------------------------------


def load_cam(path: str, interval_scale: float = 1.0,
             num_depth: int | None = None, max_d: int = 0) -> np.ndarray:
    """Parse an MVSNet ``*_cam.txt`` → (2, 4, 4) float32 camera.

    ``interval_scale`` multiplies the depth interval. If the depth line has
    fewer than 4 numbers and ``num_depth`` (or, where it is None,
    ``max_d``) is above 0, it gives the hypothesis count and
    ``depth_max = depth_min + (num_depth − 1) · interval``."""
    n = _native()
    if n:
        nd = num_depth if num_depth is not None else (max_d or 0)
        try:
            return n.load_cam(path, interval_scale, int(nd))
        except RuntimeError:
            pass  # the Python reader raises the precise exception
    return _load_cam_py(path, interval_scale, num_depth, max_d)


def _load_cam_py(path: str, interval_scale: float = 1.0,
                 num_depth: int | None = None, max_d: int = 0) -> np.ndarray:
    """The Python reader, bit-equal to the C path: the depth line in double,
    ``depth_max`` from the float32 depth_min and interval in double and
    rounded once (Python floats, whatever numpy's promotion rules), and
    nothing filled in for a count of 0."""
    with open(path, "r") as f:
        words = f.read().split()
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    try:
        ei = words.index("extrinsic")
        vals = [float(w) for w in words[ei + 1: ei + 17]]
        cam[0] = np.array(vals, dtype=np.float32).reshape(4, 4)
        ki = words.index("intrinsic")
        vals = [float(w) for w in words[ki + 1: ki + 10]]
        cam[1, :3, :3] = np.array(vals, dtype=np.float32).reshape(3, 3)
        depth_words = words[ki + 10:]
    except (ValueError, IndexError) as e:
        raise ValueError(f"Malformed cam file {path!r}") from e

    nums = [float(w) for w in depth_words]
    nd = int(num_depth if num_depth is not None else (max_d or 0))
    if len(nums) >= 1:
        cam[1, 3, 0] = nums[0]                        # depth_min
    if len(nums) >= 2:
        cam[1, 3, 1] = nums[1] * float(interval_scale)  # depth_interval
    if len(nums) >= 4:
        cam[1, 3, 2] = nums[2]                        # num_depth
        cam[1, 3, 3] = nums[3]                        # depth_max
    elif nd > 0:
        cam[1, 3, 2] = nd
        cam[1, 3, 3] = float(cam[1, 3, 0]) + (nd - 1) * float(cam[1, 3, 1])
    return cam


def write_cam(path: str, cam: np.ndarray) -> None:
    """Write a (2, 4, 4) camera in MVSNet cam.txt format."""
    cam = np.asarray(cam)
    lines = ["extrinsic"]
    for r in range(4):
        lines.append(" ".join(repr(float(v)) for v in cam[0, r]))
    lines.append("")
    lines.append("intrinsic")
    for r in range(3):
        lines.append(" ".join(repr(float(v)) for v in cam[1, r, :3]))
    lines.append("")
    lines.append(" ".join(repr(float(v)) for v in cam[1, 3]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_pair(path: str) -> Dict[int, List[Tuple[int, float]]]:
    """Parse ``pair.txt`` → {ref_view: [(src_view, score), ...] best-first}.

    Format: NUM_VIEWPOINTS, then per view its id and a line
    ``NUM_SRC src0 score0 src1 score1 ...``."""
    with open(path, "r") as f:
        words = f.read().split()
    n = int(words[0])
    out: Dict[int, List[Tuple[int, float]]] = {}
    i = 1
    for _ in range(n):
        ref = int(words[i]); i += 1
        k = int(words[i]); i += 1
        srcs = []
        for _ in range(k):
            srcs.append((int(words[i]), float(words[i + 1])))
            i += 2
        out[ref] = srcs
    return out


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type → samples per pixel


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. raw (H, W·bpp) filtered bytes, ftype (H,)
    → (H, W, bpp) uint8. Rows with filters None / Sub / Up are undone a row
    at a time; Average and Paeth depend on the reconstructed left, upper and
    upper-left pixels, so an image with any such row is undone along
    anti-diagonals, every pixel of a diagonal at once."""
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    filt = raw.reshape(h, w, bpp)
    if (ftype <= 2).all():
        out = np.empty_like(filt)
        prior = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            if ftype[r] == 0:
                out[r] = filt[r]
            elif ftype[r] == 1:
                out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)   # wraps mod 256
            else:
                out[r] = filt[r] + prior
            prior = out[r]
        return out
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)      # zero row above, column left
    f32 = filt.astype(np.int32)
    kind = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        k = kind[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        rec[r + 1, x + 1] = (f32[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG → (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"Not a PNG file: {path!r}")
    pos, idat, ihdr = len(_PNG_SIG), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"PNG without IHDR: {path!r}")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path!r}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}; read_png takes 8-bit, "
                         f"non-interlaced grey or RGB(A) images")
    bpp = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * bpp):
        raise ValueError(f"{path!r}: {rows.size} image bytes, want {h * (1 + w * bpp)}")
    rows = rows.reshape(h, 1 + w * bpp)
    n = _native()
    px = n.png_unfilter(rows, h, w, bpp) if n else _unfilter(rows[:, 1:], rows[:, 0], h, w, bpp)
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _filter_rows(img: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 → (H, 1 + W·C) filtered rows, row r with ftype[r]."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    k = ftype[:, None, None]
    pred = np.choose(np.broadcast_to(k, x.shape), preds)
    out = ((x - pred) & 255).astype(np.uint8).reshape(x.shape[0], -1)
    return np.concatenate([ftype[:, None].astype(np.uint8), out], axis=1)


def write_png(path: str, img: np.ndarray, filters: int | Sequence[int] = 2) -> None:
    """Write (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as PNG.
    ``filters``: the row filter (0-4) for every row, or one per row (Up by
    default: cheap to undo; the tests write all five)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(img.shape[2]) if img.ndim == 3 else None
    if color is None:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4); got {img.shape}")
    h, w = img.shape[:2]
    ftype = np.broadcast_to(np.asarray(filters, np.int64), (h,))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(_filter_rows(img, ftype).tobytes())))
        f.write(chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """Read a PNG or a JPEG, told apart by their first bytes as
    ``cv2.imread`` does → (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_PNG_SIG):
        return read_png(path)
    if head.startswith(b"\xff\xd8"):
        return read_jpeg(path)
    raise ValueError(f"{path!r} is neither a PNG nor a JPEG (first bytes {head!r})")
