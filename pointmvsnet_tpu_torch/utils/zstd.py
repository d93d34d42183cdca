"""Zstandard decoder in numpy and plain Python (RFC 8878), without
dictionaries: the codec of the JAX package's orbax checkpoints, which the
port reads on a host that has no ``zstandard`` module (``orbax_reader.py``).

``decompress(data)`` decodes every frame of ``data`` and concatenates
their content; skippable frames are skipped. It covers raw, RLE and
compressed blocks; literals stored raw, as RLE, Huffman-coded with their
own table or with the previous one ("treeless"), in one or four streams,
the table's weights given directly or FSE-coded; sequences whose
literal-length, offset and match-length codes use the predefined, RLE,
FSE-coded or repeated tables, and the three repeat offsets; and the
content checksum (the low 32 bits of XXH64), checked where a frame
declares one. Decoding is table-driven: the FSE and Huffman tables are
Python lists and each symbol costs a few list lookups.

A frame that names a dictionary, sets a reserved bit, runs past the end
of the input, or whose bitstreams, sizes or checksum disagree raises
``ValueError`` saying which.
"""

from __future__ import annotations

import functools

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = range(0x184D2A50, 0x184D2A60)
_BLOCK_MAX = 1 << 17

# literal-length and match-length codes → (baseline, extra bits) (RFC 8878 §3.1.1.3.2.1.1)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]

# predefined distributions (§3.1.1.3.2.2): (normalized counts, accuracy log)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                -1, -1, -1, -1, -1], 5)
# (predefined, largest symbol, largest accuracy log) for LL, OF, ML, in the order
# their tables appear in a block
_SEQ_KINDS = ((_LL_DEFAULT, 35, 9), (_OF_DEFAULT, 31, 8), (_ML_DEFAULT, 52, 9))


def _corrupt(what: str):
    return ValueError(f"zstd: {what}")


def _take(data: bytes, pos: int, n: int) -> bytes:
    if n < 0 or pos + n > len(data):
        raise _corrupt(f"input ends at byte {len(data)}, {n} bytes wanted at {pos}")
    return data[pos:pos + n]


class _BackBits:
    """A backward bitstream (§4.1): read from its end towards its start,
    each field little-endian; the highest set bit of the last byte marks
    where the data begins. Reads past the start give zeros and make
    ``left`` negative (the FSE decoders use that to stop)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("bitstream without its end mark")
        self.data = bytes(8) + bytes(data)          # 64 zero bits below the start
        self.pos = 64 + 8 * (len(data) - 1) + data[-1].bit_length() - 1

    @property
    def left(self) -> int:
        return self.pos - 64

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        if p < 0:
            raise _corrupt("bitstream read far past its start")
        self.pos = p
        return (int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE (§4.1)
# ---------------------------------------------------------------------------


def _read_counts(src: bytes, max_symbol: int, max_log: int):
    """An FSE table description (§4.1.1) → (normalized counts, accuracy
    log, bytes used). Counts are −1 for "less than 1"."""
    v = int.from_bytes(src, "little")
    log = (v & 15) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} > {max_log}")
    pos, remaining, threshold, nbits = 4, (1 << log) + 1, 1 << log, log + 1
    counts, prev_zero = [], False
    while remaining > 1:
        if prev_zero:
            while True:                               # 2-bit repeat flags of zeros
                r = (v >> pos) & 3
                pos += 2
                counts += [0] * r
                if r != 3:
                    break
        if len(counts) > max_symbol:
            raise _corrupt(f"FSE counts past symbol {max_symbol}")
        top = 2 * threshold - 1 - remaining
        low = (v >> pos) & (threshold - 1)
        if low < top:
            count, pos = low, pos + nbits - 1
        else:
            count = (v >> pos) & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            pos += nbits
        count -= 1
        remaining -= abs(count)
        if remaining < 1:
            raise _corrupt("FSE counts exceed the table")
        counts.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if pos > 8 * len(src):
        raise _corrupt("FSE table description runs past its input")
    return counts, log, (pos + 7) >> 3


def _fse_table(counts, log: int):
    """Normalized counts → decoding table (symbol, bits, baseline) per state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(c):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise _corrupt("FSE counts do not fill the table")
    nxt = [1 if c == -1 else c for c in counts]
    nb, base = [0] * size, [0] * size
    for i, s in enumerate(sym):
        x = nxt[s]
        nxt[s] += 1
        nb[i] = log - (x.bit_length() - 1)
        base[i] = (x << nb[i]) - size
    return log, sym, nb, base


@functools.cache
def _default_table(kind: int):
    counts, log = _SEQ_KINDS[kind][0]
    return _fse_table(counts, log)


# ---------------------------------------------------------------------------
# Huffman-coded literals (§4.2)
# ---------------------------------------------------------------------------


def _huffman_weights_fse(src: bytes):
    """FSE-coded Huffman weights: two interleaved states on one table."""
    counts, log, used = _read_counts(src, 255, 6)
    _, sym, nb, base = _fse_table(counts, log)
    bits = _BackBits(src[used:])
    s1, s2 = bits.read(log), bits.read(log)
    out = []
    while len(out) < 255:
        out.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.left < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.left < 0:
            out.append(sym[s1])
            break
    else:
        raise _corrupt("more than 255 Huffman weights")
    return out


def _huffman_table(src: bytes):
    """A Huffman tree description → (bytes used, (max bits, symbol per
    peek, bits per peek)); each table has 2**max_bits entries."""
    head = _take(src, 0, 1)[0]
    if head < 128:
        weights, used = _huffman_weights_fse(_take(src, 1, head)), 1 + head
    else:
        n = head - 127
        raw = _take(src, 1, (n + 1) // 2)
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        used = 1 + len(raw)
    total = sum(1 << (w - 1) for w in weights if w)
    if not total or max(weights) > 11:
        raise _corrupt("invalid Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise _corrupt("Huffman weights do not sum to a power of two")
    weights.append(rest.bit_length())
    if max_bits > 11:
        raise _corrupt(f"Huffman codes of {max_bits} bits")
    syms, nbs = [], []
    for w in range(1, max_bits + 1):                 # lowest weight first, then symbol order
        span, nb = 1 << (w - 1), max_bits + 1 - w
        for s, ws in enumerate(weights):
            if ws == w:
                syms += [s] * span
                nbs += [nb] * span
    return used, (max_bits, syms, nbs)


def _huffman_stream(src: bytes, table, n: int) -> bytes:
    max_bits, syms, nbs = table
    bits = _BackBits(src)
    data, p, mask = bits.data, bits.pos, (1 << max_bits) - 1
    out = bytearray(n)
    for i in range(n):
        q = p - max_bits                             # ≥ 53: the 64 zero bits below
        w = (int.from_bytes(data[q >> 3:(q >> 3) + 4], "little") >> (q & 7)) & mask
        out[i] = syms[w]
        p -= nbs[w]
    if p != 64:
        raise _corrupt("Huffman stream not consumed exactly")
    return bytes(out)


def _literals(block: bytes, state):
    """The literals section of a compressed block → (literals, bytes used)."""
    b0 = _take(block, 0, 1)[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:                                     # raw or RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (_take(block, 1, 1)[0] << 4), 2
        else:
            h = _take(block, 1, 2)
            size, head = (b0 >> 4) + (h[0] << 4) + (h[1] << 12), 3
        if kind == 0:
            return _take(block, head, size), head + size
        return _take(block, head, 1) * size, head + 1
    head, nbits = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    h = int.from_bytes(_take(block, 0, head), "little") >> 4
    regen, csize = h & ((1 << nbits) - 1), h >> nbits
    if regen > _BLOCK_MAX:
        raise _corrupt(f"{regen} literals in a block")
    body = _take(block, head, csize)
    if kind == 2:
        used, state.huffman = _huffman_table(body)
        body = body[used:]
    elif state.huffman is None:
        raise _corrupt("treeless literals without an earlier Huffman table")
    if fmt == 0:
        return _huffman_stream(body, state.huffman, regen), head + csize
    sizes = [int.from_bytes(_take(body, 2 * i, 2), "little") for i in range(3)]
    sizes.append(len(body) - 6 - sum(sizes))
    per = (regen + 3) // 4
    counts = [per, per, per, regen - 3 * per]
    if sizes[3] < 1 or counts[3] < 0:
        raise _corrupt("four Huffman streams do not fit their sizes")
    out, start = [], 6
    for size, count in zip(sizes, counts):
        out.append(_huffman_stream(body[start:start + size], state.huffman, count))
        start += size
    return b"".join(out), head + csize


# ---------------------------------------------------------------------------
# Sequences (§3.1.1.3.2) and their execution (§3.1.1.4)
# ---------------------------------------------------------------------------


def _sequence_tables(block: bytes, pos: int, modes: int, state):
    tables = []
    for kind, shift in enumerate((6, 4, 2)):          # LL, OF, ML
        mode = (modes >> shift) & 3
        _, max_symbol, max_log = _SEQ_KINDS[kind]
        if mode == 0:
            table = _default_table(kind)
        elif mode == 1:
            s = _take(block, pos, 1)[0]
            pos += 1
            if s > max_symbol:
                raise _corrupt(f"RLE code {s} > {max_symbol}")
            table = (0, [s], [0], [0])
        elif mode == 2:
            counts, log, used = _read_counts(block[pos:], max_symbol, max_log)
            table = _fse_table(counts, log)
            pos += used
        else:
            table = state.seq_tables[kind]
            if table is None:
                raise _corrupt("repeated sequence table without an earlier one")
        tables.append(table)
    state.seq_tables = tables
    return tables, pos


def _sequences(block: bytes, pos: int, literals: bytes, out: bytearray, state) -> None:
    """Decode the sequences section at ``pos`` and execute it into ``out``."""
    b0 = _take(block, pos, 1)[0]
    if b0 == 0:
        if pos + 1 != len(block):
            raise _corrupt("bytes after an empty sequences section")
        out += literals
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + _take(block, pos + 1, 1)[0], pos + 2
    else:
        nseq, pos = int.from_bytes(_take(block, pos + 1, 2), "little") + 0x7F00, pos + 3
    modes = _take(block, pos, 1)[0]
    if modes & 3:
        raise _corrupt("reserved bits set in the sequence modes")
    tables, pos = _sequence_tables(block, pos + 1, modes, state)
    (ll_log, ll_sym, ll_nb, ll_base), (of_log, of_sym, of_nb, of_base), \
        (ml_log, ml_sym, ml_nb, ml_base) = tables
    bits = _BackBits(block[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = state.rep
    lit = 0
    for i in range(nseq):
        of_code = of_sym[of_s]
        ml_base_v, ml_bits = _ML[ml_sym[ml_s]]
        ll_base_v, ll_bits = _LL[ll_sym[ll_s]]
        offset = (1 << of_code) + read(of_code)
        ml = ml_base_v + read(ml_bits)
        ll = ll_base_v + read(ll_bits)
        if offset > 3:
            offset -= 3
            rep = [offset, rep[0], rep[1]]
        else:
            idx = offset - (ll != 0)                  # 0..3 into rep1, rep2, rep3, rep1 − 1
            if idx == 0:
                offset = rep[0]
            elif idx == 1:
                offset = rep[1]
                rep = [offset, rep[0], rep[2]]
            else:
                offset = rep[2] if idx == 2 else rep[0] - 1
                if offset == 0:
                    raise _corrupt("repeat offset 0")
                rep = [offset, rep[0], rep[1]]
        if lit + ll > len(literals):
            raise _corrupt("sequences use more literals than the block has")
        out += literals[lit:lit + ll]
        lit += ll
        start = len(out) - offset
        if start < 0:
            raise _corrupt(f"match offset {offset} before the start of the frame")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            out += (out[start:] * (ml // offset + 1))[:ml]
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if bits.left != 0:
        raise _corrupt("sequences bitstream not consumed exactly")
    state.rep = rep
    out += literals[lit:]


# ---------------------------------------------------------------------------
# Frames (§3.1)
# ---------------------------------------------------------------------------


class _FrameState:
    """What a block may take from earlier blocks of its frame."""

    def __init__(self):
        self.huffman = None
        self.seq_tables = [None, None, None]
        self.rep = [1, 4, 8]


def _frame(data: bytes, pos: int):
    """The frame whose header starts at ``pos`` (after the magic) →
    (content, position after the frame)."""
    fhd = _take(data, pos, 1)[0]
    pos += 1
    single, checksum, did_size = (fhd >> 5) & 1, (fhd >> 2) & 1, (0, 1, 2, 4)[fhd & 3]
    if fhd & 8:
        raise _corrupt("reserved bit set in the frame header")
    if not single:
        pos += 1                                     # window descriptor: all output is kept
    did = int.from_bytes(_take(data, pos, did_size), "little")
    pos += did_size
    if did:
        raise ValueError(f"zstd: frame needs dictionary {did}; dictionaries are not supported")
    fcs_size = (single, 2, 4, 8)[fhd >> 6]
    fcs = int.from_bytes(_take(data, pos, fcs_size), "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    out, state = bytearray(), _FrameState()
    while True:
        head = int.from_bytes(_take(data, pos, 3), "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if size > _BLOCK_MAX:
            raise _corrupt(f"block of {size} bytes")
        if kind == 0:
            out += _take(data, pos, size)
            pos += size
        elif kind == 1:
            out += _take(data, pos, 1) * size
            pos += 1
        elif kind == 2:
            block = _take(data, pos, size)
            pos += size
            n0 = len(out)
            literals, used = _literals(block, state)
            _sequences(block, used, literals, out, state)
            if len(out) - n0 > _BLOCK_MAX:
                raise _corrupt("a block decodes to more than 128 KiB")
        else:
            raise _corrupt("reserved block type")
        if last:
            break
    if fcs_size and len(out) != fcs:
        raise _corrupt(f"frame holds {len(out)} bytes, its header says {fcs}")
    if checksum:
        want = int.from_bytes(_take(data, pos, 4), "little")
        pos += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise _corrupt("content checksum mismatch")
    return bytes(out), pos


def decompress(data) -> bytes:
    """Every frame of ``data`` decoded and concatenated; skippable frames
    are skipped."""
    data = bytes(data)
    if not data:
        raise _corrupt("no frame in an empty input")
    out, pos = [], 0
    while pos < len(data):
        magic = int.from_bytes(_take(data, pos, 4), "little")
        if magic == MAGIC:
            content, pos = _frame(data, pos + 4)
            out.append(content)
        elif magic in _SKIPPABLE:
            pos += 8 + int.from_bytes(_take(data, pos + 4, 4), "little")
            if pos > len(data):
                raise _corrupt("skippable frame runs past the input")
        else:
            raise _corrupt(f"unknown frame magic {magic:#010x} at byte {pos}")
    return b"".join(out)


# ---------------------------------------------------------------------------
# XXH64 (the content checksum)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = n - n % 32
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data[:p], "<u8").tolist()
        for i in range(0, len(lanes), 4):
            v = [_round(v[0], lanes[i]), _round(v[1], lanes[i + 1]),
                 _round(v[2], lanes[i + 2]), _round(v[3], lanes[i + 3])]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        k = _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ ((int.from_bytes(data[p:p + 4], "little") * _P1) & _M64), 23) * _P2
             + _P3) & _M64
        p += 4
    for b in data[p:]:
        h = (_rotl(h ^ ((b * _P5) & _M64), 11) * _P1) & _M64
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)
