"""The image path of the port's C++ data plane (native/src/image.cpp)
against its Python and numpy versions, which stay beside it as the plain
versions, and against the JAX package's cv2 reads: baseline JPEG decode on
cv2's corpus (4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey at quality 50 / 95 /
100, two sizes, restart intervals 1 and 3, a 1600×1200 file) and on
write_jpeg's output; unsupported, truncated and corrupt files, which raise
the same exception with the same text on both paths or give the same
bytes; the PNG row unfilter on every filter and colour type; the linear
resize; DTU and Tanks & Temples items with the C path on and off; the
rebuild when either source changes.

Bars against cv2 are tests/test_torch_jpeg.py's (JPEG: 1 level for grey
and 4:4:4, 2 where chroma is subsampled), tests/test_torch_eval.py's
(linear resize: 1e-3 in float32 on a 0-255 range, 1 level in uint8) and
exact for PNG. Between the C and the Python paths every bar is bit-equality."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from pointmvsnet_tpu.dataset.dtu import _read_image as jread_image
from pointmvsnet_tpu.dataset.preprocess import resize_image as jresize_image
from pointmvsnet_tpu_torch import native
from pointmvsnet_tpu_torch.dataset import io, jpeg
from pointmvsnet_tpu_torch.dataset.dtu import DTUTestDataset, DTUTrainValDataset
from pointmvsnet_tpu_torch.dataset.preprocess import _linear_taps, _resize_linear_py, resize_image
from pointmvsnet_tpu_torch.dataset.synthetic import _texture, make_synthetic_dtu
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_tanks
from pointmvsnet_tpu_torch.dataset.tanks import TanksDataset
from torch_threads import one_torch_thread  # noqa: F401

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
CV2_FILES = [f"{s}-q{q}-{h}x{w}" for s in ("444", "422", "420", "440", "grey")
             for q in (50, 95, 100) for h, w in ((37, 53), (64, 80))]
OTHER_FILES = ["rst1", "rst3", "420-q95-1200x1600", "write_jpeg-64x80", "write_jpeg-37x53"]


@pytest.fixture(autouse=True)
def c_path(monkeypatch):
    """The readers choose again, without PMVS_NO_NATIVE: the C path."""
    monkeypatch.delenv("PMVS_NO_NATIVE", raising=False)
    monkeypatch.setattr(io, "_NATIVE", None)


def image(h, w, seed=0):
    return _texture(np.random.RandomState(seed), h, w)


def cv2_jpeg(path, x, sampling, quality, extra=()):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if sampling == "grey":
        cv2.imwrite(path, cv2.cvtColor(x, cv2.COLOR_RGB2GRAY), params)
    else:
        cv2.imwrite(path, x[..., ::-1], params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                  SAMPLING[sampling]])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """name → path of every file of the corpus."""
    root = tmp_path_factory.mktemp("jpegs")
    files = {}
    for name in CV2_FILES:
        sampling, q, size = name.split("-")
        h, w = map(int, size.split("x"))
        files[name] = str(root / f"{name}.jpg")
        cv2_jpeg(files[name], image(h, w, seed=int(q[1:])), sampling, int(q[1:]))
    for interval in (1, 3):
        files[f"rst{interval}"] = str(root / f"rst{interval}.jpg")
        cv2.imwrite(files[f"rst{interval}"], image(37 * 3, 53 * 3)[..., ::-1],
                    [cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    files["420-q95-1200x1600"] = str(root / "big.jpg")
    cv2_jpeg(files["420-q95-1200x1600"], image(1200, 1600, seed=5), "420", 95)
    for h, w in ((64, 80), (37, 53)):
        files[f"write_jpeg-{h}x{w}"] = str(root / f"port{h}.jpg")
        jpeg.write_jpeg(files[f"write_jpeg-{h}x{w}"], image(h, w, seed=7))
    return files


def read(path):
    with open(path, "rb") as f:
        return f.read()


def outcome(decode, data):
    """("bytes", the image) or (the exception's type, its text)."""
    try:
        return "bytes", decode(data)
    except Exception as e:  # noqa: BLE001 - the kind and text are what is compared
        return type(e), str(e)


def same_outcome(data, what):
    """The C path and the Python path give the same bytes or raise the same
    exception with the same text. → the outcome."""
    c, py = outcome(jpeg.decode_jpeg, data), outcome(jpeg._decode_jpeg_py, data)
    assert c[0] == py[0], (what, c, py)
    if c[0] == "bytes":
        assert c[1].dtype == py[1].dtype == np.uint8 and c[1].shape == py[1].shape, what
        np.testing.assert_array_equal(c[1], py[1], err_msg=what)
    else:
        assert c[1] == py[1], what
    return c


# ------------------------------------------------------------------ JPEG

@pytest.mark.parametrize("name", CV2_FILES + OTHER_FILES)
def test_jpeg_c_path_equals_python_and_cv2(corpus, name):
    path = corpus[name]
    data = read(path)
    before = native.loads["jpeg"]
    got = io.read_jpeg(path)
    assert native.loads["jpeg"] == before + 1
    np.testing.assert_array_equal(got, jpeg._decode_jpeg_py(data))
    want = jread_image(path)
    bar = 1 if name.startswith(("444", "grey")) else 2
    d = np.abs(got.astype(np.int64) - want)
    assert got.shape == want.shape and d.max() <= bar, (name, d.max())


def sof0_at(data):
    return data.index(b"\xff\xc0")


def unsupported(kind, corpus):
    data = read(corpus["420-q95-64x80"])
    if kind == "progressive":
        path = corpus["420-q95-64x80"] + ".progressive.jpg"
        cv2.imwrite(path, image(64, 80)[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        return read(path)
    if kind == "arithmetic":                       # SOF0 rewritten to SOF9
        p = sof0_at(data)
        return data[:p + 1] + b"\xc9" + data[p + 2:]
    if kind == "12-bit":                           # the precision byte
        p = sof0_at(data) + 4
        return data[:p] + b"\x0c" + data[p + 1:]
    return b"\x89PNG" + data


@pytest.mark.parametrize("kind,text", [("progressive", "progressive"),
                                       ("arithmetic", "arithmetic-coded"),
                                       ("12-bit", "12-bit"), ("not a JPEG", "SOI")])
def test_jpeg_unsupported_files_raise_alike(corpus, kind, text):
    kind_, msg = same_outcome(unsupported(kind, corpus), kind)
    assert kind_ is ValueError and text in msg


def entropy_span(data):
    """[first, last) byte offsets of the first scan's entropy-coded data."""
    sos = data.index(b"\xff\xda")
    (length,) = struct.unpack(">H", data[sos + 2:sos + 4])
    return sos + 2 + length, data.rindex(b"\xff\xd9")


BASES = ["420-q95-64x80", "grey-q50-37x53", "422-q100-64x80", "444-q50-37x53", "rst1", "rst3"]


@pytest.mark.parametrize("base", BASES)
def test_jpeg_truncated_alike(corpus, base):
    """Cut at 30 seeded offsets: the same outcome on both paths."""
    data = read(corpus[base])
    rng = np.random.RandomState(len(data))
    seen = set()
    for cut in rng.randint(2, len(data), 30):
        seen.add(same_outcome(data[:cut], f"{base} cut at {cut}")[0])
    assert ValueError in seen


@pytest.mark.parametrize("base", BASES)
def test_jpeg_corrupt_entropy_alike(corpus, base):
    """1, 3 or 12 seeded entropy-coded bytes replaced by random ones, 60
    files: the same bytes or the same exception on both paths. Over the
    bases the corruption reaches the decoder's errors (no code matches,
    more than 64 coefficients, a read past the data) and wrong images."""
    data = read(corpus[base])
    lo, hi = entropy_span(data)
    rng = np.random.RandomState(hi)
    kinds = {}
    for i in range(60):
        buf = bytearray(data)
        for p in rng.randint(lo, hi, [1, 3, 12][i % 3]):
            buf[p] = rng.randint(256)
        kind, val = same_outcome(bytes(buf), f"{base} corruption {i}")
        key = "bytes" if kind == "bytes" else val.split(":")[0]
        kinds[key] = kinds.get(key, 0) + 1
    print(base, kinds)
    assert "corrupt JPEG entropy-coded data" in kinds or "JPEG block has more than 64 " \
        "coefficients" in kinds


# A grey baseline JPEG built bit by bit: 8 rows of n blocks, a DC table
# whose 16 symbols (sizes 0-15) have 5-bit codes, an AC table of one code
# ("0": EOB), all quantisation steps 1.
DC_BITS = bytes([0, 0, 0, 0, 16] + [0] * 11)
DC_VALS = bytes(range(16))
AC_BITS = bytes([1] + [0] * 15)


def grey_jpeg(dc_diffs, dri=0, tail=b"\xff\xd9", drop_rst=False, cut=0):
    """Each block: its DC difference, then EOB. dri > 0 writes restart
    markers every dri blocks (drop_rst leaves them out, so the scan has
    fewer intervals than its MCUs need); cut drops that many bytes of the
    entropy-coded data's end."""
    n = len(dc_diffs)
    segs, bits = [], []

    def flush():
        bits.extend([1] * (-len(bits) % 8))
        raw = np.packbits(np.array(bits, np.uint8)).tobytes()
        segs.append(raw.replace(b"\xff", b"\xff\x00"))
        bits.clear()

    for i, d in enumerate(dc_diffs):
        if dri and i and i % dri == 0:
            flush()
        s = int(abs(d)).bit_length()
        bits.extend(int(b) for b in f"{s:05b}")
        if s:
            bits.extend(int(b) for b in f"{d if d > 0 else d + (1 << s) - 1:0{s}b}")
        bits.append(0)                                    # EOB
    flush()
    scan = b""
    for i, seg in enumerate(segs):
        scan += seg
        if i + 1 < len(segs) and not drop_rst:
            scan += bytes([0xFF, 0xD0 + i % 8])
    scan = scan[:len(scan) - cut]

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    return b"".join([
        b"\xff\xd8",
        seg(0xDB, bytes([0]) + bytes([1] * 64)),
        seg(0xC0, struct.pack(">BHHB", 8, 8, 8 * n, 1) + bytes([1, 0x11, 0])),
        seg(0xC4, bytes([0x00]) + DC_BITS + DC_VALS + bytes([0x10]) + AC_BITS + bytes([0])),
        seg(0xDD, struct.pack(">H", dri)) if dri else b"",
        seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])),
        scan, tail])


def test_grey_jpeg_decodes_to_its_dc_levels():
    """grey_jpeg's file decodes to the blocks' DC levels on both paths."""
    diffs = [40, -80, 20, 0, 200]
    kind, img = same_outcome(grey_jpeg(diffs), "built")
    levels = np.clip((np.cumsum(diffs) + 4) // 8 + 128, 0, 255)   # islow: DC / 8, rounded
    assert kind == "bytes" and (img[:, ::8, 0] == levels).all()


@pytest.mark.parametrize("case,want", [
    ("no EOI", "JPEG scan runs to the end of the file (no EOI)"),
    ("read past the data", "corrupt JPEG entropy-coded data: array index out of range"),
    ("no code", "corrupt JPEG entropy-coded data: cannot unpack non-iterable NoneType object"),
    ("too few restarts", "JPEG scan has fewer restart intervals than MCUs need"),
    # block 199's DC (base 64·199, prediction 32767·200) lands at 12836
    ("DC past the coefficients", "index 12836 is out of bounds for axis 0 with size 12800"),
    ("DC wraps into the next block", None),
])
def test_jpeg_scan_errors_alike(case, want):
    """Each error of the scan decoder, and a DC prediction beyond int16
    (the Python path packs it with the coefficient's index, so the carry
    moves the write into a later coefficient, or past the array)."""
    data = {
        "no EOI": grey_jpeg([5] * 20, tail=b""),
        "read past the data": grey_jpeg([5] * 20, cut=14),
        "no code": grey_jpeg([5] * 20, tail=b"\xff\x00" * 4 + b"\xff\xd9", cut=10),
        "too few restarts": grey_jpeg([5] * 20, dri=4, drop_rst=True),
        "DC past the coefficients": grey_jpeg([32767] * 200),
        "DC wraps into the next block": grey_jpeg([32767] * 100),
    }[case]
    kind, val = same_outcome(data, case)
    if want is None:
        assert kind == "bytes"
        clean = grey_jpeg([min(32767, 2047)] + [0] * 99)
        assert not np.array_equal(val, jpeg._decode_jpeg_py(clean))
    else:
        assert val == want


def test_jpeg_scan_header_past_the_end_alike(corpus):
    """An SOS whose length reaches past the file: the scan's data would
    start past the end; "no EOI" on both paths."""
    data = read(corpus["420-q95-64x80"])
    p = data.index(b"\xff\xda")
    kind, val = same_outcome(data[:p + 2] + struct.pack(">H", len(data)) + data[p + 4:], "SOS")
    assert kind is ValueError and val == "JPEG scan runs to the end of the file (no EOI)"


def test_jpeg_truncated_huffman_table_alike(corpus):
    """A DHT whose values stop short: IndexError on both paths."""
    data = read(corpus["420-q95-64x80"])
    p = data.index(b"\xff\xc4")
    (length,) = struct.unpack(">H", data[p + 2:p + 4])
    short = data[:p + 2] + struct.pack(">H", 19 + 2) + data[p + 4:p + 4 + 19] + \
        data[p + 2 + length:]
    kind, val = same_outcome(short, "short DHT")
    assert kind is IndexError and val == "index out of range"


# ------------------------------------------------------------------ PNG

def png_bytes(img, color, filters):
    """A PNG of any colour type (write_png writes no grey + alpha)."""
    h, w = img.shape[:2]
    ftype = np.broadcast_to(np.asarray(filters, np.int64), (h,))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (io._PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(io._filter_rows(img, ftype).tobytes()))
            + chunk(b"IEND", b""))


FILTERS = [0, 1, 2, 3, 4, "mixed"]


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_c_equals_python(filters, bpp):
    """Random filtered bytes under each filter type and a random mix."""
    rng = np.random.RandomState(bpp)
    h, w = 23, 31
    raw = rng.randint(0, 256, (h, 1 + w * bpp)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h) if filters == "mixed" else filters
    before = native.loads["png"]
    got = native.png_unfilter(raw, h, w, bpp)
    assert native.loads["png"] == before + 1
    np.testing.assert_array_equal(got, io._unfilter(raw[:, 1:], raw[:, 0], h, w, bpp))


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_read_png_colour_types(tmp_path, monkeypatch, color, filters):
    """read_png with the C path, with PMVS_NO_NATIVE=1 and cv2 (the JAX
    package's read) on grey, RGB, grey + alpha and RGBA files."""
    rng = np.random.RandomState(color)
    img = (rng.rand(19, 27, io._CHANNELS[color]) * 255).astype(np.uint8)
    if filters == "mixed":
        filters = list(rng.randint(0, 5, 19))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png_bytes(img, color, filters))
    got = io.read_png(path)
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    io.reset_native()
    np.testing.assert_array_equal(got, io.read_png(path))
    np.testing.assert_array_equal(got, jread_image(path))
    np.testing.assert_array_equal(got, np.repeat(img[..., :1], 3, 2) if color in (0, 4)
                                  else img[..., :3])


def test_png_unknown_filter_raises_alike():
    raw = np.zeros((3, 1 + 4 * 3), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError) as c:
        native.png_unfilter(raw, 3, 4, 3)
    with pytest.raises(ValueError) as py:
        io._unfilter(raw[:, 1:], raw[:, 0], 3, 4, 3)
    assert str(c.value) == str(py.value) == "unknown PNG filter type 7"


# ------------------------------------------------------------------ resize

RESIZES = [((1200, 1600), (480, 640)), ((37, 53), (64, 80)), ((64, 80), (37, 53)),
           ((64, 80), (32, 40)), ((1, 1), (5, 7)), ((1, 9), (1, 4)), ((9, 1), (4, 3)),
           ((5, 7), (1, 1)), ((12, 17), (12, 17)), ((101, 67), (131, 29))]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resize_linear_c_equals_numpy_and_cv2(src, dst, dtype):
    rng = np.random.RandomState(src[0] + dst[1])
    for shape in (src + (3,), src):
        x = (rng.rand(*shape) * 255).astype(dtype)
        before = native.loads["resize"]
        got = resize_image(x, dst, "linear")
        assert native.loads["resize"] == before + 1
        want = _resize_linear_py(x, _linear_taps(dst[0], src[0]), _linear_taps(dst[1], src[1]))
        assert got.dtype == want.dtype == np.dtype(dtype) and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        ref = jresize_image(x, dst, "linear").reshape(got.shape)
        d = np.abs(got.astype(np.float64) - ref).max()
        assert d <= (1 if dtype == "uint8" else 1e-3), (shape, dst, d)


def test_resize_linear_float64_and_strided_input():
    """Float64 and non-contiguous input: converted to float32 first, as numpy."""
    x = np.random.RandomState(0).rand(40, 30, 3) * 255
    for img in (x, x[::2, ::-1], np.asfortranarray(x)):
        got = resize_image(img, (17, 23), "linear")
        want = _resize_linear_py(img, _linear_taps(17, img.shape[0]),
                                 _linear_taps(23, img.shape[1]))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------------ items

def assert_items_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.atleast_1d(a[k]), np.atleast_1d(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8), err_msg=f"{what} {k}")


def both_paths(make, n, monkeypatch, kinds):
    """Items 0..n-1 with the C path (which must count ``kinds``), then with
    PMVS_NO_NATIVE=1 (which counts nothing)."""
    before = dict(native.loads)
    c_items = [make()[i] for i in range(n)]
    for kind in kinds:
        assert native.loads[kind] > before[kind], (kind, before, native.loads)
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    io.reset_native()
    before = dict(native.loads)
    py_items = [make()[i] for i in range(n)]
    assert native.loads == before
    return c_items, py_items


def test_dtu_test_item_c_and_python_paths(tmp_path, monkeypatch):
    """An eval-release tree of JPEGs at 96×160, scaled to fit 64×128 (linear)."""
    root = str(tmp_path / "dtu_eval")
    make_synthetic_dtu(root, scans=[1], num_views=3, height=96, width=160, num_depth=16,
                       layout="eval")
    kw = dict(num_view=3, num_virtual_plane=16, img_height=64, img_width=128, base=32)
    c_items, py_items = both_paths(lambda: DTUTestDataset(root, **kw), 3, monkeypatch,
                                   ("jpeg", "resize", "cam"))
    for i in range(3):
        assert c_items[i]["images"].shape == (3, 64, 96, 3)
        assert_items_equal(c_items[i], py_items[i], f"DTU test item {i}")


def test_dtu_train_item_c_and_python_paths(tmp_path, monkeypatch):
    root = str(tmp_path / "dtu_train")
    make_synthetic_dtu(root, scans=[2], num_views=3, height=48, width=64, num_depth=16)
    kw = dict(mode="train", num_view=3, num_virtual_plane=16)
    c_items, py_items = both_paths(lambda: DTUTrainValDataset(root, **kw), 4, monkeypatch,
                                   ("png", "pfm", "cam"))
    for i in range(4):
        assert_items_equal(c_items[i], py_items[i], f"DTU train item {i}")


def test_tanks_item_c_and_python_paths(tmp_path, monkeypatch):
    root = str(tmp_path / "tanks")
    make_synthetic_tanks(root, scenes=["Family"], num_views=3, num_depth=16, height=80,
                         width=144)
    kw = dict(num_view=3, num_virtual_plane=16, img_height=64, img_width=128, base=32)
    c_items, py_items = both_paths(lambda: TanksDataset(root, **kw), 3, monkeypatch,
                                   ("jpeg", "resize", "cam"))
    for i in range(3):
        assert_items_equal(c_items[i], py_items[i], f"T&T item {i}")


# ------------------------------------------------------------------ build

def test_library_rebuilds_when_either_source_changes(tmp_path, monkeypatch):
    """The library's name hashes both sources: an edit to either gives a
    new name, and build() compiles it."""
    srcs = []
    for src in native.SRCS:
        srcs.append(tmp_path / src.name)
        srcs[-1].write_bytes(src.read_bytes())
    monkeypatch.setattr(native, "SRCS", tuple(srcs))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    names = {native.lib_path().name}
    for src in srcs:
        src.write_bytes(src.read_bytes() + b"\n// edited\n")
        names.add(native.lib_path().name)
    assert len(names) == 3 and all(n.startswith("dataplane-") for n in names)
    built = native.build()
    assert built.name == native.lib_path().name and built.exists()
    assert [f.name for f in (tmp_path / "build").iterdir()] == [built.name]


def test_failed_build_raises_for_images(tmp_path, monkeypatch):
    """No quiet fallback: where the library cannot be built, the JPEG and
    PNG readers and the linear resize raise with the compiler's error;
    PMVS_NO_NATIVE=1 alone selects their Python versions."""
    jpg, png = str(tmp_path / "x.jpg"), str(tmp_path / "x.png")
    img = image(16, 24)
    jpeg.write_jpeg(jpg, img)
    io.write_png(png, img, filters=4)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    for call in (lambda: io.read_jpeg(jpg), lambda: io.read_png(png),
                 lambda: resize_image(img.astype(np.float32), (8, 12), "linear")):
        with pytest.raises(RuntimeError, match="no-such-g"):
            call()
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    io.reset_native()
    before = dict(native.loads)
    np.testing.assert_array_equal(io.read_png(png), img)
    assert io.read_jpeg(jpg).shape == (16, 24, 3)
    assert resize_image(img.astype(np.float32), (8, 12), "linear").shape == (8, 12, 3)
    assert native.loads == before
