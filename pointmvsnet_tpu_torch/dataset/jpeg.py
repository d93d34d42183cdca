"""Baseline JPEG in numpy and the standard library: the port's stand-in for
``cv2.imread`` / ``cv2.imwrite`` on ``.jpg`` files.

Reader (``read_jpeg``): sequential DCT with Huffman coding (SOF0 / SOF1),
8-bit samples, 1 or 3 components, any integral sampling factors,
interleaved or not, restart markers, sizes that are not a multiple of the
MCU. It follows libjpeg's defaults, so that its output can match
``cv2.imread(path, IMREAD_COLOR)`` followed by BGR→RGB:

- the integer "islow" IDCT of ``jidctint.c`` (CONST_BITS 13, PASS1_BITS 2)
  with libjpeg's post-IDCT range limit;
- "fancy" triangle upsampling of chroma subsampled by 2 (``jdsample.c``:
  h2v1, h1v2 and h2v2, edges replicated at the downsampled size), box
  replication for other integral factors;
- the fixed-point YCbCr→RGB tables of ``jdcolor.c`` (16 fraction bits).

The entropy decode of each scan and the reconstruction (dequantisation,
IDCT, upsampling, colour) run in the port's C++ library
(``native/src/image.cpp``) unless ``PMVS_NO_NATIVE`` is set; the marker
parse stays here, so the C code sees only validated headers. The Python
versions beside it (``_decode_jpeg_py``) give the same bytes and raise the
same exceptions: Huffman decoding as a Python loop over one 65,536-entry
lookup table per Huffman table, reading 32-bit windows of the
entropy-coded bits, the rest in numpy. Progressive, arithmetic-coded,
lossless, hierarchical and 12-bit files raise ``ValueError`` naming what
they are. EXIF orientation is not applied.

Writer (``write_jpeg``): baseline, 4:2:0, the Annex K quantisation tables
scaled to quality 95 (cv2's default) as libjpeg scales them, the Annex K
Huffman tables, a JFIF header; libjpeg's fixed-point RGB→YCbCr and
chroma averaging, a float DCT, and a vectorised Huffman coder.
"""

from __future__ import annotations

import array
import functools
import struct

import numpy as np

# zigzag index → natural (row-major) index of an 8×8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZIGZAG = np.argsort(_NATURAL)            # natural index → zigzag index

_SOF_KINDS = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential)",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}

# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _huffman_lookup(bits: bytes, vals: bytes) -> list:
    """Canonical codes of (bits[1..16], vals) → a list indexed by the next
    16 bits of the stream, an entry (bits, run, value) per index:

    - value > 0: the code and its magnitude bits fit in the 16 bits;
      ``bits`` is their total length, the coefficient is value − 32768;
    - value == 0: a symbol of size 0 (EOB, ZRL, a DC difference of 0);
    - value < 0: a code whose magnitude bits, −value of them, reach past
      the 16 bits (``bits`` is the code's length);
    - None where no code matches.

    The run is the symbol's high nibble (0 for DC tables)."""
    table = [None] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            sym = vals[k]
            k += 1
            r, s = sym >> 4, sym & 15
            lo, n = code << (16 - length), 1 << (16 - length)
            if s == 0 or length + s > 16:
                table[lo:lo + n] = [(length, r, -s)] * n
            else:
                m = np.arange(n) >> (16 - length - s)           # the magnitude bits
                v = np.where(m < (1 << (s - 1)), m - ((1 << s) - 1), m) + 32768
                entries = {int(x): (length + s, r, int(x)) for x in np.unique(v)}
                table[lo:lo + n] = [entries[x] for x in v.tolist()]
            code += 1
        code <<= 1
    return table


def _bit_windows(data: bytes) -> array.array:
    """win[p] = the 32 bits of ``data`` starting at bit p (MSB first),
    zeros past the end, for every p up to 8·len(data) + 32."""
    n = len(data) + 5
    b = np.frombuffer(data + bytes(9), np.uint8).astype(np.uint64)
    v = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    win = array.array("I")
    win.frombytes(((v[:, None] >> shifts) & 0xFFFFFFFF).astype(np.uint32).tobytes())
    return win


def _entropy_segments(data: bytes, start: int):
    """The entropy-coded data of the scan at ``start``, unstuffed and split at
    its restart markers. → (segments, offset of the marker that ends it)."""
    arr = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(arr[start:] == 0xFF) + start
    segs, cur, seg_start = [], bytearray(), start
    for p in ff.tolist():
        nxt = data[p + 1] if p + 1 < len(data) else None
        if nxt == 0x00:                          # stuffed 0xFF
            cur += data[seg_start:p + 1]
            seg_start = p + 2
        elif nxt == 0xFF:                        # fill byte before a marker
            cur += data[seg_start:p]
            seg_start = p + 1
        elif nxt is not None and 0xD0 <= nxt <= 0xD7:    # RSTn
            cur += data[seg_start:p]
            segs.append(bytes(cur))
            cur = bytearray()
            seg_start = p + 2
        else:
            cur += data[seg_start:p]
            segs.append(bytes(cur))
            return segs, p
    raise ValueError("JPEG scan runs to the end of the file (no EOI)")


_MASK = [(1 << s) - 1 for s in range(17)]
_HALF = [1 << (s - 1) if s else 0 for s in range(17)]


def _decode_scan(segs, n_mcu, restart, slots, offsets, dc_tabs, ac_tabs):
    """Huffman-decode one sequential scan. ``slots[i]`` / ``offsets[i]``:
    the scan component and the flat coefficient offset (×64) of the i-th
    block in stream order; blocks per MCU = len(slots) / n_mcu. → the
    nonzero coefficients as (flat index << 16) | (value + 32768), zigzag
    within each block, DC values un-predicted (one append per value)."""
    starts, acc = [], 0
    for s in segs:
        starts.append(acc)
        acc += 8 * len(s)
    win = _bit_windows(b"".join(segs))
    out = []
    put = out.append
    mask, half = _MASK, _HALF
    bpm = len(slots) // max(n_mcu, 1)
    preds = [0] * len(dc_tabs)
    pos, seg, i = 0, 0, 0
    try:
        for m in range(n_mcu):
            if restart and m and m % restart == 0:
                seg += 1
                if seg >= len(starts):
                    raise ValueError("JPEG scan has fewer restart intervals than MCUs need")
                pos = starts[seg]
                preds = [0] * len(dc_tabs)
            for _ in range(bpm):
                c = slots[i]
                base = offsets[i]
                i += 1
                act = ac_tabs[c]
                w = win[pos]
                ln, _, val = dc_tabs[c][w >> 16]
                if val > 0:
                    preds[c] += val - 32768
                elif val < 0:                        # magnitude bits past the peek
                    s = -val
                    v = (w >> (32 - ln - s)) & mask[s]
                    preds[c] += v - mask[s] if v < half[s] else v
                    ln += s
                pos += ln
                if preds[c]:
                    put((base << 16) + preds[c] + 32768)
                k = 1
                while k < 64:
                    w = win[pos]
                    ln, r, val = act[w >> 16]
                    if val > 0:
                        k += r
                        put(((base + k) << 16) + val)
                        k += 1
                        pos += ln
                    elif val == 0:
                        pos += ln
                        if r != 15:                  # EOB
                            break
                        k += 16                      # ZRL: 16 zeros
                    else:
                        s = -val
                        k += r
                        v = (w >> (32 - ln - s)) & mask[s]
                        put(((base + k) << 16) + (v - mask[s] if v < half[s] else v) + 32768)
                        k += 1
                        pos += ln + s
                if k > 64:
                    raise ValueError("JPEG block has more than 64 coefficients")
    except (TypeError, IndexError) as e:            # no code matched / ran off the data
        raise ValueError(f"corrupt JPEG entropy-coded data: {e}") from None
    return out


# jidctint.c constants: FIX(x) = round(x · 2^13)
_F0298, _F0390, _F0541, _F0765, _F0899, _F1175 = 2446, 3196, 4433, 6270, 7373, 9633
_F1501, _F1847, _F1961, _F2053, _F2562, _F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _idct_1d(c, shift: int):
    """One pass of libjpeg's islow IDCT on 8 int64 arrays (the 8
    coefficients along one axis) → 8 arrays, descaled by ``shift``."""
    c0, c1, c2, c3, c4, c5, c6, c7 = c
    z1 = (c2 + c6) * _F0541
    tmp2 = z1 - c6 * _F1847
    tmp3 = z1 + c2 * _F0765
    tmp0 = (c0 + c4) << 13
    tmp1 = (c0 - c4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1, z2, z3, z4 = c7 + c1, c5 + c3, c7 + c3, c5 + c1
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = c7 * _F0298, c5 * _F2053, c3 * _F3072, c1 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    rnd = 1 << (shift - 1)
    return [(x + rnd) >> shift for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# libjpeg's post-IDCT range limit: index (x & 1023) → clamp(x + 128) for
# |x| < 512 (and libjpeg's wraparound beyond)
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def _idct_blocks(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients (N, 8, 8) int64, natural order → samples
    (N, 8, 8) uint8 (jidctint.c: columns first, then rows)."""
    ws = np.stack(_idct_1d([coef[:, u, :] for u in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, v] for v in range(8)], 18), axis=2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: (H, w) → (H, 2w), edges replicated."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_v2(x: np.ndarray, h2: bool) -> np.ndarray:
    """h1v2 / h2v2 fancy upsampling: (h, W) → (2h, W) or (2h, 2W)."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0],) + x.shape[1:], np.int32)
    if not h2:                                   # h1v2: (colsum + 1|2) >> 2
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    res = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, far in ((0, up), (1, down)):
        cs = 3 * x + far                         # vertical column sums
        last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        res[r::2, 0::2] = (3 * cs + last + 8) >> 4
        res[r::2, 1::2] = (3 * cs + nxt + 7) >> 4
    return res


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane at its downsampled size → full size (uint8)."""
    if (fh, fv) == (1, 1):
        return plane
    wide = plane.shape[1] > 2
    if (fh, fv) == (2, 1) and wide:
        return _fancy_h2(plane).astype(np.uint8)
    if (fh, fv) == (1, 2):
        return _fancy_v2(plane, h2=False).astype(np.uint8)
    if (fh, fv) == (2, 2) and wide:
        return _fancy_v2(plane, h2=True).astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


# jdcolor.c: Cr→R, Cb→B, and the G terms, 16 fraction bits
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (91881 * _X + 32768) >> 16               # FIX(1.40200) = 91881
_CB_B = (116130 * _X + 32768) >> 16              # FIX(1.77200) = 116130
_CR_G = -46802 * _X                              # FIX(0.71414) = 46802
_CB_G = -22554 * _X + 32768                      # FIX(0.34414) = 22554


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8 RGB (see the module docstring)."""
    from pointmvsnet_tpu_torch.dataset.io import _native      # io imports this module
    lib = _native()
    return _decode(data, _NativeCodec(lib) if lib else _PythonCodec)


def _decode_jpeg_py(data: bytes) -> np.ndarray:
    """``decode_jpeg`` in Python and numpy alone: the plain version of the
    C path, and the PMVS_NO_NATIVE path."""
    return _decode(data, _PythonCodec)


def _decode(data: bytes, codec) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt, dc_h, ac_h = {}, {}, {}
    frame, restart, adobe = None, 0, None
    coefs = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker == 0xD9:                       # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_KINDS:
            raise ValueError(f"{_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}) is not supported: "
                             f"read_jpeg takes baseline sequential Huffman files")
        if marker in (0xC0, 0xC1):
            prec, h, w, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported: read_jpeg takes 8-bit samples")
            if h == 0:
                raise ValueError("JPEG with a DNL height is not supported")
            if nf not in (1, 3):
                raise ValueError(f"JPEG with {nf} components is not supported (1 or 3)")
            comps = []
            for c in range(nf):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                if hmax % c["h"] or vmax % c["v"]:
                    raise ValueError(f"JPEG sampling factors {[(k['h'], k['v']) for k in comps]} "
                                     f"are not integral ratios")
                c["bw"], c["bh"] = mx * c["h"], my * c["v"]          # padded block grid
                c["dw"] = -(-w * c["h"] // hmax)                      # downsampled size
                c["dh"] = -(-h * c["v"] // vmax)
            frame = dict(h=h, w=w, comps=comps, hmax=hmax, vmax=vmax, mx=mx, my=my)
            offs = np.cumsum([0] + [c["bw"] * c["bh"] for c in comps])
            for c, o in zip(comps, offs):
                c["off"] = int(o)
            coefs = np.zeros(int(offs[-1]) * 64, codec.coef_dtype)
        elif marker == 0xC4:                     # DHT
            p = 0
            while p < len(body):
                tc_th = body[p]
                bits = body[p + 1:p + 17]
                n = sum(bits)
                (ac_h if tc_th >> 4 else dc_h)[tc_th & 15] = codec.table(
                    bits, body[p + 17:p + 17 + n])
                p += 17 + n
        elif marker == 0xDB:                     # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    q = np.frombuffer(body[p + 1:p + 129], ">u2").astype(np.int64)
                    p += 129
                else:
                    q = np.frombuffer(body[p + 1:p + 65], np.uint8).astype(np.int64)
                    p += 65
                qt[tq] = q[_ZIGZAG]              # natural order
        elif marker == 0xDD:                     # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif marker == 0xDA:                     # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            by_id = {c["id"]: c for c in frame["comps"]}
            scomps, dct, act = [], [], []
            for j in range(ns):
                cid, tdta = body[1 + 2 * j:3 + 2 * j]
                if cid not in by_id or tdta >> 4 not in dc_h or tdta & 15 not in ac_h:
                    raise ValueError(f"JPEG scan names an undefined component {cid} or "
                                     f"Huffman table {tdta:#04x}")
                scomps.append(by_id[cid])
                dct.append(dc_h[tdta >> 4])
                act.append(ac_h[tdta & 15])
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            if (ss, se) != (0, 63):
                raise ValueError(f"JPEG scan with spectral selection {ss}..{se} (progressive)")
            slots, offsets, n_mcu = _scan_layout(frame, scomps)
            pos = codec.scan(data, pos, n_mcu, restart, slots, offsets, dct, act, coefs)
    if frame is None or coefs is None:
        raise ValueError("JPEG without a frame or a scan")
    return codec.reconstruct(frame, coefs, qt, adobe)


def _scan_layout(frame, scomps):
    """Stream order of a scan's blocks: (slot per block, coefficient offset
    per block, MCU count); the first two as arrays."""
    if len(scomps) == 1:                         # non-interleaved: the component's own grid
        c = scomps[0]
        nbw, nbh = -(-c["dw"] // 8), -(-c["dh"] // 8)
        r = np.arange(nbh)[:, None] * c["bw"] + np.arange(nbw)[None, :]
        offsets = (c["off"] + r.ravel()) * 64
        return np.zeros(offsets.size, np.int32), offsets, offsets.size
    per_mcu = []
    for j, c in enumerate(scomps):
        for v in range(c["v"]):
            for hh in range(c["h"]):
                per_mcu.append((j, c, v, hh))
    my, mx = np.meshgrid(np.arange(frame["my"]), np.arange(frame["mx"]), indexing="ij")
    my, mx = my.ravel(), mx.ravel()
    offs = np.stack([(c["off"] + (my * c["v"] + v) * c["bw"] + mx * c["h"] + hh) * 64
                     for _, c, v, hh in per_mcu], axis=1)
    slots = np.tile(np.array([j for j, _, _, _ in per_mcu], np.int32), my.size)
    return slots, offs.ravel(), my.size


def _reconstruct(frame, coefs, qt, adobe) -> np.ndarray:
    h, w = frame["h"], frame["w"]
    planes = []
    for c in frame["comps"]:
        n = c["bw"] * c["bh"]
        blk = coefs[c["off"] * 64:(c["off"] + n) * 64].reshape(n, 64)[:, _ZIGZAG]
        blk = (blk * qt[c["tq"]]).reshape(n, 8, 8)
        pix = _idct_blocks(blk).reshape(c["bh"], c["bw"], 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["dh"], :c["dw"]]
        full = _upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(full[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if _is_rgb(frame, adobe):
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def _is_rgb(frame, adobe) -> bool:
    """Three components stored as RGB: an Adobe transform of 0, or no Adobe
    segment and the component ids "RGB"."""
    ids = bytes(c["id"] for c in frame["comps"])
    return adobe == 0 or (adobe is None and ids == b"RGB")


class _PythonCodec:
    """The scan decode and the reconstruction in Python and numpy."""

    coef_dtype = np.int64
    table = staticmethod(_huffman_lookup)
    reconstruct = staticmethod(_reconstruct)

    @staticmethod
    def scan(data, start, n_mcu, restart, slots, offsets, dct, act, coefs) -> int:
        segs, end = _entropy_segments(data, start)
        packed = np.asarray(_decode_scan(segs, n_mcu, restart, slots.tolist(), offsets.tolist(),
                                         dct, act), np.int64)
        coefs[packed >> 16] = (packed & 0xFFFF) - 32768
        return end


class _NativeCodec:
    """The scan decode and the reconstruction in the C++ library."""

    coef_dtype = np.int16          # every scattered value is (p & 0xFFFF) − 32768

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def table(bits: bytes, vals: bytes):
        if len(bits) < 16 or len(vals) < sum(bits):
            raise IndexError("index out of range")   # where _huffman_lookup runs out of bytes
        return bits, vals

    def scan(self, data, start, n_mcu, restart, slots, offsets, dct, act, coefs) -> int:
        specs = list(dict.fromkeys(dct + act))
        return self.lib.jpeg_scan(data, start, n_mcu, restart, slots, offsets, specs,
                                  np.array([specs.index(t) for t in dct], np.int32),
                                  np.array([specs.index(t) for t in act], np.int32), coefs)

    def reconstruct(self, frame, coefs, qt, adobe) -> np.ndarray:
        comps = frame["comps"]
        q = np.stack([qt[c["tq"]] for c in comps])
        info = np.array([[c["off"], c["bw"], c["bh"], c["dw"], c["dh"], frame["hmax"] // c["h"],
                          frame["vmax"] // c["v"]] for c in comps], np.int32)
        mode = 0 if len(comps) == 1 else 1 if _is_rgb(frame, adobe) else 2
        return self.lib.jpeg_reconstruct(coefs, info, q, frame["h"], frame["w"], mode)


def read_jpeg(path: str) -> np.ndarray:
    """Read a baseline JPEG → (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_jpeg(data)
    except ValueError as e:
        raise ValueError(f"{path!r}: {e}") from None


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

QUALITY = 95

# Annex K.1 tables, natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# Annex K.3 Huffman tables: (bits[1..16], values)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _scaled_quant(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(spec):
    """(bits, values) → (codes (256,), lengths (256,)) by symbol."""
    bits, vals = spec
    codes, lens = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lens[vals[k]] = code, length
            k += 1
            code += 1
        code <<= 1
    return codes, lens


def _dht(tc_th: int, spec) -> bytes:
    bits, vals = spec
    return bytes([tc_th]) + bytes(bits) + bytes(vals)


def _fdct_matrix() -> np.ndarray:
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    d[0] *= np.sqrt(0.5)
    return d


def _rgb_to_ycc(img: np.ndarray):
    """jccolor.c rgb_ycc_convert (16 fraction bits) → Y, Cb, Cr int64."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + half - 1) >> 16
    return y, cb, cr


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8·bh, 8·bw) → (bh, bw, 8, 8)."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _bitlen(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _encode_blocks(zz: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code quantised blocks in stream order. zz (N, 64) zigzag
    int64, comp (N,) component of each block (0 luma, 1 / 2 chroma)."""
    n = zz.shape[0]
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for c in (0, 1, 2):
        m = comp == c
        diff[m] = np.diff(dc[m], prepend=0)
    tab = (comp > 0).astype(np.int64)            # 0 luma tables, 1 chroma
    (dcc, dcl), (acc, acl) = tables
    keys, vals, lens = [], [], []

    def emit(key, val, length):
        keys.append(key)
        vals.append(val)
        lens.append(length)

    blk = np.arange(n, dtype=np.int64) * 1024
    s = _bitlen(diff)
    emit(blk, dcc[tab, s], dcl[tab, s])
    emit(blk + 1, np.where(diff < 0, diff + (1 << s) - 1, diff), s)

    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run >> 4
    if nzrl.any():                               # ZRL codes before a long run
        rep = np.repeat(np.arange(len(b)), nzrl)
        j = np.arange(rep.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        emit(b[rep] * 1024 + k[rep] * 8 + j, acc[tab[b[rep]], 0xF0], acl[tab[b[rep]], 0xF0])
    s = _bitlen(v)
    sym = (run & 15) * 16 + s
    emit(b * 1024 + k * 8 + 4, acc[tab[b], sym], acl[tab[b], sym])
    emit(b * 1024 + k * 8 + 5, np.where(v < 0, v + (1 << s) - 1, v), s)
    last = np.zeros(n, np.int64)
    at_end = np.ones(len(b), bool)               # k ascends within a block
    at_end[:-1] = b[1:] != b[:-1]
    last[b[at_end]] = k[at_end]
    eob = np.flatnonzero(last < 63)
    emit(eob * 1024 + 512, acc[tab[eob], 0x00], acl[tab[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    j = np.arange(total) - np.repeat(start, ln)
    bits = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - j)) & 1
    pad = -total % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def encode_jpeg(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB → baseline 4:2:0 JPEG bytes at ``QUALITY``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    mh, mw = -(-h // 16) * 16, -(-w // 16) * 16
    padded = np.pad(img, ((0, mh - h), (0, mw - w), (0, 0)), mode="edge")
    y, cb, cr = _rgb_to_ycc(padded)
    bias = np.tile([1, 2], mw // 4)              # h2v2_downsample's alternating bias

    def down(p):
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        return (s + bias[None, :]) >> 2

    qy = _scaled_quant(_STD_LUMA_Q, QUALITY)
    qc = _scaled_quant(_STD_CHROMA_Q, QUALITY)
    d = _fdct_matrix()

    def quantise(plane, q):
        blk = _blocks(plane.astype(np.float64) - 128)
        f = np.einsum("ui,abij,vj->abuv", d, blk, d)
        return np.rint(f / q.reshape(8, 8)).astype(np.int64).reshape(*f.shape[:2], 64)[..., _NATURAL]

    zy = quantise(y, qy)                          # (2·MY, 2·MX, 64)
    zcb, zcr = quantise(down(cb), qc), quantise(down(cr), qc)
    my, mx = mh // 16, mw // 16
    ymcu = zy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    zz = np.concatenate([ymcu, zcb[:, :, None], zcr[:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    tables = []
    for luma, chroma in ((_DC_LUMA, _DC_CHROMA), (_AC_LUMA, _AC_CHROMA)):
        (lc, ll), (cc, cl) = _code_table(luma), _code_table(chroma)
        tables.append((np.stack([lc, cc]), np.stack([ll, cl])))
    scan = _encode_blocks(zz, comp, tables)

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    return b"".join([
        b"\xff\xd8",
        seg(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HHBB", 1, 1, 0, 0)),
        seg(0xDB, bytes([0]) + bytes(qy[_NATURAL].astype(np.uint8))
            + bytes([1]) + bytes(qc[_NATURAL].astype(np.uint8))),
        seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        seg(0xC4, _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
            + _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)),
        seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


def write_jpeg(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a baseline 4:2:0 JPEG at quality 95."""
    data = encode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)
