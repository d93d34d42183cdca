"""The port's C++ data plane (pointmvsnet_tpu_torch/native) against the JAX
package's library and readers: PFM and cam.txt reads bit-equal across the
port's C path, its Python readers and the JAX package's default readers
(its C path), the batch reader, standardize and the nearest resize, the
error types, the build (a failed build raises, concurrent builds agree,
only PMVS_NO_NATIVE selects Python), and DTU / Tanks & Temples items with
the C path on and off."""

import ctypes
import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pointmvsnet_tpu import native as jnative
from pointmvsnet_tpu.dataset import io as jio
from pointmvsnet_tpu.dataset.dtu import DTUTrainValDataset as JDTUTrainValDataset
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_dtu as jmake_synthetic_dtu
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_tanks as jmake_synthetic_tanks
from pointmvsnet_tpu.dataset.tanks import TanksDataset as JTanksDataset
from pointmvsnet_tpu_torch import native
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.dtu import DTUTrainValDataset
from pointmvsnet_tpu_torch.dataset.preprocess import norm_image, resize_image
from pointmvsnet_tpu_torch.dataset.tanks import TanksDataset
from torch_threads import one_torch_thread  # noqa: F401

CAM_HEAD = ("extrinsic\n{}\n{}\n{}\n{}\n\nintrinsic\n{}\n{}\n{}\n\n{}\n")


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def assert_bit_equal(got, want, msg=""):
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=msg)


@pytest.fixture(scope="module", autouse=True)
def jax_reads_through_its_library():
    """The JAX package's default readers take its C path wherever its
    library builds; that default is the reference here."""
    assert jio._native(), f"the JAX package's data plane did not build: {jnative.build_error()}"


@pytest.fixture
def python_path(monkeypatch):
    """PMVS_NO_NATIVE=1 for the port: its readers choose again, then Python."""
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    monkeypatch.setattr(io, "_NATIVE", None)


# ------------------------------------------------------------------ PFM

def write_raw_pfm(path, data, scale, little, comment=False):
    """A PFM as other writers make them: either byte order, any scale (its
    sign follows the byte order), optionally a comment line."""
    data = np.asarray(data, np.float32)
    tag = b"PF" if data.ndim == 3 else b"Pf"
    with open(path, "wb") as f:
        f.write(tag + b"\n" + (b"# written by a test\n" if comment else b""))
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale}\n".encode())
        f.write(np.flipud(data).astype("<f4" if little else ">f4").tobytes())


@pytest.mark.parametrize("shape", [(33, 47), (1, 13), (17, 1), (9, 11, 3), (1, 1, 3)])
@pytest.mark.parametrize("little", [True, False])
@pytest.mark.parametrize("scale", [1.0, 2.5, 0.37, 0.0])
def test_pfm_paths_bit_equal(tmp_path, shape, little, scale):
    rng = np.random.RandomState(sum(shape))
    data = (rng.randn(*shape) * 300).astype(np.float32)
    for comment in (False, True):
        p = str(tmp_path / f"d{comment}.pfm")
        write_raw_pfm(p, data, scale, little, comment)
        want = jio.load_pfm(p)
        assert_bit_equal(native.load_pfm(p), want)
        assert_bit_equal(io.load_pfm(p), want)
        assert_bit_equal(io._load_pfm_py(p), want)
        assert_bit_equal(jnative.load_pfm(p), want)
        if scale == 0.0 and little:      # "-0.0" is not below 0: read as big-endian
            assert_bit_equal(want, data.astype("<f4").view(">f4").astype(np.float32))
        else:
            assert_bit_equal(want, data * np.float32(scale) if scale not in (0.0, 1.0) else data)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("n_threads", [1, 4, 0])
def test_pfm_batch_equals_single_loads(tmp_path, channels, n_threads):
    rng = np.random.RandomState(channels + n_threads)
    shape = (24, 30) if channels == 1 else (24, 30, 3)
    paths = []
    for i in range(9):
        paths.append(str(tmp_path / f"{i}.pfm"))
        write_raw_pfm(paths[-1], rng.rand(*shape) * 100, [1.0, 2.5][i % 2], i % 3 != 0)
    before = native.loads["pfm"]
    got = native.load_pfm_batch(paths, 24, 30, channels, n_threads=n_threads)
    assert native.loads["pfm"] - before == len(paths)
    assert_bit_equal(got, np.stack([jio.load_pfm(p) for p in paths]))
    assert_bit_equal(got, jnative.load_pfm_batch(paths, 24, 30, channels, n_threads=n_threads))


def test_pfm_batch_rejects_a_map_of_another_size(tmp_path):
    """A map smaller or larger than the batch's plane fails (the JAX
    package's library accepts a smaller one and leaves the rest unwritten)."""
    paths = [str(tmp_path / f"{i}.pfm") for i in range(3)]
    for p, shape in zip(paths, [(8, 8), (8, 8), (8, 7)]):
        io.write_pfm(p, np.ones(shape, np.float32))
    with pytest.raises(RuntimeError, match="code -11"):
        native.load_pfm_batch(paths, 8, 8)
    with pytest.raises(RuntimeError, match="code -11"):
        native.load_pfm_batch(paths[2:], 8, 6)
    with pytest.raises(RuntimeError, match="code -10"):
        native.load_pfm_batch(paths[:2] + [str(tmp_path / "missing.pfm")], 8, 8, n_threads=2)


def test_write_pfm_scale_round_trips(tmp_path):
    """write_pfm(scale=) as the JAX package's: the header carries |scale|
    and every reader multiplies by it."""
    data = np.random.RandomState(3).rand(6, 5).astype(np.float32)
    for scale in (1.0, 2.5, -0.37):
        a, b = str(tmp_path / "port.pfm"), str(tmp_path / "jax.pfm")
        io.write_pfm(a, data, scale=scale)
        jio.write_pfm(b, data, scale=scale)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        want = data * np.float32(abs(scale))
        for read in (io.load_pfm, io._load_pfm_py, jio.load_pfm, jio._load_pfm_py):
            assert_bit_equal(read(a), want, f"{read.__module__}.{read.__name__} scale {scale}")


# ------------------------------------------------------------------ cam.txt

def cam_number(rng, lo, hi):
    """A number in [lo, hi) as a file may hold it: as write_cam writes a
    float32 (its repr), or with 1-9 significant digits."""
    x = rng.uniform(lo, hi)
    digits = rng.randint(0, 10)
    return repr(float(np.float32(x))) if digits == 0 else f"{x:.{digits}g}"


def random_cam_text(rng):
    num = lambda lo, hi: cam_number(rng, lo, hi)   # noqa: E731
    ext = [" ".join(num(-1, 1) for _ in range(3)) + " " + num(-800, 800) for _ in range(3)]
    ext.append("0.0 0.0 0.0 1.0")
    k = [f"{num(100, 3000)} 0.0 {num(0, 2000)}", f"0.0 {num(100, 3000)} {num(0, 2000)}",
         "0.0 0.0 1.0"]
    depth = [num(0.1, 1000), num(0.001, 10), str(rng.choice([48, 96, 128, 192])),
             num(100, 3000)][:rng.randint(1, 5)]
    return CAM_HEAD.format(*ext, *k, " ".join(depth))


@pytest.fixture(scope="module")
def cam_sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("cams")
    rng = np.random.RandomState(2024)
    paths = []
    for i in range(2000):
        paths.append(str(root / f"{i:04d}_cam.txt"))
        with open(paths[-1], "w") as f:
            f.write(random_cam_text(rng))
    return paths


def float32_depth_max(depth_min, interval, nd):
    """depth_max as numpy ≥ 2 computes the JAX package's Python line in
    float32 (two roundings)."""
    with np.errstate(over="ignore"):
        return np.float32(depth_min) + np.float32(nd - 1) * np.float32(interval)


SWEEP_KW = [dict(num_depth=None), dict(num_depth=0), dict(num_depth=48), dict(num_depth=96),
            dict(num_depth=192), dict(num_depth=None, max_d=64), dict(num_depth=0, max_d=64)]


@pytest.mark.parametrize("interval_scale", [1.0, 1.06, 0.8])
def test_cam_sweep_paths_bit_equal(cam_sweep, interval_scale):
    """2000 seeded cam files, depth lines of 1-4 numbers, each read under
    every count: the port's C path, its Python reader and the JAX package's
    default load_cam agree bit for bit."""
    rounded_twice = 0
    for path in cam_sweep:
        for kw in SWEEP_KW:
            want = jio.load_cam(path, interval_scale, **kw)
            nd = kw["num_depth"] if kw["num_depth"] is not None else kw.get("max_d", 0)
            got = {"C": native.load_cam(path, interval_scale, nd),
                   "io": io.load_cam(path, interval_scale, **kw),
                   "python": io._load_cam_py(path, interval_scale, **kw)}
            for name, cam in got.items():
                assert_bit_equal(cam, want, f"{name} {path} {kw}")
            if nd > 0 and want[1, 3, 3] != float32_depth_max(want[1, 3, 0], want[1, 3, 1], nd):
                rounded_twice += 1
    assert rounded_twice > 100     # the sweep meets depth_max's rounding often


def test_depth_max_pinned(tmp_path, python_path):
    """depth_min 889.80736, interval 4.9225346 × 0.8, 96 depths: the C path
    rounds once to 1263.9200439453125; float32 arithmetic gives
    1263.919921875."""
    p = str(tmp_path / "cam.txt")
    with open(p, "w") as f:
        f.write(CAM_HEAD.format(*["1 0 0 0"] * 4, *["1 0 0"] * 3, "889.80736 4.9225346"))
    want = np.float32(1263.9200439453125)
    assert jio.load_cam(p, 0.8, 96)[1, 3, 3] == want
    assert float32_depth_max(889.80736, np.float32(4.9225346 * 0.8), 96) == np.float32(
        1263.919921875)
    for cam in (io.load_cam(p, 0.8, 96), io._load_cam_py(p, 0.8, 96), native.load_cam(p, 0.8, 96),
                io.load_cam(p, 0.8, max_d=96)):
        assert bits(cam[1, 3, 3]) == bits(want)
        assert_bit_equal(cam, jio.load_cam(p, 0.8, 96))


def test_load_cam_max_d_matches_jax(tmp_path):
    """max_d stands in for num_depth where that is None, as in the JAX package."""
    p = str(tmp_path / "cam.txt")
    with open(p, "w") as f:
        f.write(CAM_HEAD.format(*["1 0 0 0"] * 4, *["1 0 0"] * 3, "425.0 2.5"))
    for kw in [dict(max_d=192), dict(num_depth=48, max_d=192), dict(num_depth=None, max_d=0)]:
        assert_bit_equal(io.load_cam(p, 1.06, **kw), jio.load_cam(p, 1.06, **kw), str(kw))
    assert io.load_cam(p, max_d=192)[1, 3, 2] == 192
    assert io.load_cam(p, num_depth=48, max_d=192)[1, 3, 2] == 48


def test_strtof_equals_float_then_float32():
    """The C path reads the extrinsic and K with strtof, the Python readers
    with float() and a cast to float32. Equal on numbers as write_cam writes
    them and on every number of 1-9 significant digits tried."""
    libc = ctypes.CDLL(None)
    libc.strtof.restype, libc.strtof.argtypes = ctypes.c_float, [ctypes.c_char_p, ctypes.c_void_p]
    rng = np.random.RandomState(7)
    words = []
    for digits in range(1, 10):
        mant = rng.randint(10 ** (digits - 1), 10 ** digits, size=4000)
        exps = rng.randint(-12, 9, size=4000)
        words += [f"{m}e{e}" for m, e in zip(mant, exps)]
    words += [repr(float(v)) for v in (rng.randn(4000) * 10.0 ** rng.randint(-6, 6, 4000))
              .astype(np.float32)]
    c = np.array([libc.strtof(w.encode(), None) for w in words], np.float32)
    np.testing.assert_array_equal(bits(c), bits(np.array([float(w) for w in words], np.float32)))


# ------------------------------------------------------------------ image ops

@pytest.mark.parametrize("shape,offset", [((40, 52, 3), 0.0), ((33, 17), 0.0),
                                          ((64, 80, 1), 1000.0), ((7, 9, 3), -3.5)])
def test_standardize_matches_jax_library(shape, offset):
    img = (np.random.RandomState(shape[0]).rand(*shape) * 255 + offset).astype(np.float32)
    got = native.standardize(img.copy())
    assert_bit_equal(got, jnative.standardize(img.copy()))
    want = norm_image(img if img.ndim == 3 else img[..., None])
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=2e-5)


SRC = [(32, 40), (37, 53), (2, 3), (5, 7)]
DST = [(8, 10), (64, 80), (37, 53), (98, 147), (99, 101), (1, 1)]


@pytest.mark.parametrize("src", SRC)
def test_resize_nearest_matches_jax_library(src):
    img = np.random.RandomState(src[0]).rand(*src, 3).astype(np.float32)
    for dst in DST:
        for x in (img, img[..., 0]):
            assert_bit_equal(native.resize_nearest(x, *dst), jnative.resize_nearest(x, *dst),
                             f"{src} -> {dst}")


def test_resize_nearest_against_resize_image():
    """resize_nearest takes source index y·H // dh; resize_image (cv2's
    rule) floor(y · (1 / (dh / H))) in double, which falls one row short
    where the rounded reciprocal is below the exact ratio. On this grid
    they differ only on upscales: 32 → 98 and 2 → 98 rows (row 49), 3 → 147
    columns (49, 98). So the port keeps resize_image off the C library, as
    the JAX package does."""
    differ = set()
    for src in SRC:
        img = np.arange(src[0] * src[1], dtype=np.float32).reshape(src)
        for dst in DST:
            if not np.array_equal(native.resize_nearest(img, *dst), resize_image(img, dst)):
                differ.add((src, dst))
    assert differ == {((32, 40), (98, 147)), ((2, 3), (98, 147))}


# ------------------------------------------------------------------ errors

def bad_files(root):
    def put(name, data):
        path = str(root / name)
        with open(path, "wb") as f:
            f.write(data)
        return path
    return {
        "missing pfm": ("pfm", str(root / "missing.pfm")),
        "bad header": ("pfm", put("bad.pfm", b"P6\n1 1\n255\n")),
        "negative width": ("pfm", put("neg.pfm", b"Pf\n-3 2\n-1.0\n" + bytes(24))),
        "truncated pfm": ("pfm", put("short.pfm", b"Pf\n4 3\n-1.0\n" + bytes(40))),
        "missing cam": ("cam", str(root / "missing_cam.txt")),
        "cam without intrinsic": ("cam", put("c1.txt", b"extrinsic\n" + b"1 0 0 0\n" * 4)),
        "short extrinsic": ("cam", put("c2.txt", b"extrinsic\n1 0 0\n\nintrinsic\n1 0 0\n")),
    }


@pytest.mark.parametrize("case", ["missing pfm", "bad header", "negative width", "truncated pfm",
                                  "missing cam", "cam without intrinsic", "short extrinsic"])
def test_errors_match_jax(tmp_path, case):
    kind, path = bad_files(tmp_path)[case]
    read = {"pfm": (io.load_pfm, jio.load_pfm), "cam": (io.load_cam, jio.load_cam)}[kind]
    with pytest.raises(Exception) as want:
        read[1](path)
    with pytest.raises(want.type):
        read[0](path)
    with pytest.raises(RuntimeError):
        (native.load_pfm if kind == "pfm" else native.load_cam)(path)


# ------------------------------------------------------------------ build

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(io, "_NATIVE", None)
    monkeypatch.delenv("PMVS_NO_NATIVE", raising=False)
    return tmp_path


def test_failed_build_raises(fresh_build, monkeypatch):
    tmp = fresh_build
    pfm = str(tmp / "d.pfm")
    io.write_pfm(pfm, np.ones((2, 3), np.float32))
    missing = str(tmp / "no-such-g++")
    monkeypatch.setattr(native, "CXX", missing)
    for read in (io.load_pfm, io.load_cam):
        with pytest.raises(RuntimeError, match="no-such-g"):
            read(pfm)
    assert not native.available() and "no-such-g" in native.build_error()

    fake = tmp / "fake-g++"
    fake.write_text('#!/bin/sh\n[ "$1" = -dumpfullversion ] && { echo 0.0; exit 0; }\n'
                    'echo "dataplane.cpp:1: error: the compiler refused" >&2\nexit 1\n')
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="the compiler refused"):
        io.load_pfm(pfm)
    assert not list((tmp / "build").glob("*.so")) and not list((tmp / "build").glob("*.tmp"))


def test_no_native_selects_python(fresh_build, monkeypatch):
    """PMVS_NO_NATIVE=1 reads in Python even where no compiler is; without
    it the C path reads (and counts)."""
    tmp = fresh_build
    pfm = str(tmp / "d.pfm")
    data = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    io.write_pfm(pfm, data)
    monkeypatch.setattr(native, "CXX", str(tmp / "no-such-g++"))
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    before = dict(native.loads)
    assert_bit_equal(io.load_pfm(pfm), data)
    assert native.loads == before and io._NATIVE is False

    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.delenv("PMVS_NO_NATIVE")
    io.reset_native()
    assert_bit_equal(io.load_pfm(pfm), data)
    assert io._NATIVE is native and native.loads["pfm"] == before["pfm"] + 1


BUILD_SCRIPT = """
import importlib.util, os, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("dataplane", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.BUILD_DIR = Path(sys.argv[2])
Path(sys.argv[3] + ".ready").touch()
while not os.path.exists(sys.argv[4]):
    time.sleep(0.01)
print(native.build())
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes build into one empty directory at the same moment:
    one library, no temporary file left, and it loads and reads."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, native.__file__, str(build_dir),
                               str(tmp_path / f"p{i}"), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    try:
        deadline = time.time() + 60
        while len(glob.glob(str(tmp_path / "p*.ready"))) < 4 and time.time() < deadline:
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert [f.name for f in build_dir.iterdir()] == [os.path.basename(outs[0][0].strip())]
    lib = ctypes.CDLL(outs[0][0].strip())
    cam = np.empty(32, np.float32)
    path = str(tmp_path / "cam.txt")
    with open(path, "w") as f:
        f.write(CAM_HEAD.format(*["1 0 0 0"] * 4, *["1 0 0"] * 3, "425.0 2.5"))
    assert lib.cam_load(path.encode(), cam.ctypes.data_as(ctypes.c_void_p), ctypes.c_double(1.0),
                        48) == 0
    assert_bit_equal(cam.reshape(2, 4, 4), jio.load_cam(path, 1.0, 48))


# ------------------------------------------------------------------ dataset items

def rewrite_depth_lines(paths, interval_scale, num_depth, seed):
    """Each cam file's depth line → two numbers near its own whose depth_max
    float32 arithmetic would round otherwise than the C path."""
    rng = np.random.RandomState(seed)
    for path in paths:
        with open(path) as f:
            lines = f.read().rstrip("\n").split("\n")
        d_min, interval = (float(w) for w in lines[-1].split()[:2])
        while True:
            a = f"{d_min + rng.uniform(-1, 1):.5f}"
            b = f"{interval * rng.uniform(0.98, 1.02):.7f}"
            i32 = np.float32(float(b) * interval_scale)
            once = np.float32(float(np.float32(float(a))) + (num_depth - 1) * float(i32))
            if once != float32_depth_max(float(a), i32, num_depth):
                break
        lines[-1] = f"{a} {b}"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def assert_items_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, (what, k)
        np.testing.assert_array_equal(bits(np.asarray(got[k], np.float32)),
                                      bits(np.asarray(want[k], np.float32)), err_msg=f"{what} {k}")


def items_both_paths(make, n, monkeypatch):
    """Items 0..n-1 of make() with the C path, then with PMVS_NO_NATIVE=1."""
    monkeypatch.setattr(io, "_NATIVE", None)
    monkeypatch.delenv("PMVS_NO_NATIVE", raising=False)
    before = native.loads["cam"]
    ds = make()
    c_items = [ds[i] for i in range(n)]
    assert native.loads["cam"] > before
    monkeypatch.setenv("PMVS_NO_NATIVE", "1")
    io.reset_native()
    ds = make()
    return c_items, [ds[i] for i in range(n)]


def test_dtu_train_item_c_and_python_paths(tmp_path, monkeypatch):
    root = str(tmp_path / "dtu")
    jmake_synthetic_dtu(root, scans=[2], num_views=3, height=48, width=64, num_depth=16)
    rewrite_depth_lines(sorted(glob.glob(os.path.join(root, "Cameras", "*_cam.txt"))), 1.06, 16, 0)
    kw = dict(mode="train", num_view=3, num_virtual_plane=16, interval_scale=1.06)
    jds = JDTUTrainValDataset(root, **kw)
    want = [jds[i] for i in range(7)]
    c_items, py_items = items_both_paths(lambda: DTUTrainValDataset(root, **kw), 7, monkeypatch)
    for i in range(7):
        assert_items_equal(c_items[i], want[i], f"C path item {i}")
        assert_items_equal(py_items[i], want[i], f"Python item {i}")


def test_tanks_item_c_and_python_paths(tmp_path, monkeypatch):
    """The JAX package's T&T tree with its JPEGs rewritten as PNGs of the
    same pixels, so that both packages read the same images."""
    import cv2
    root = str(tmp_path / "tanks")
    jmake_synthetic_tanks(root, scenes=["Family"], num_views=3, num_depth=16, height=64,
                          width=128)
    for jpg in glob.glob(os.path.join(root, "Family", "images", "*.jpg")):
        cv2.imwrite(jpg[:-4] + ".png", cv2.imread(jpg))
        os.remove(jpg)
    rewrite_depth_lines(sorted(glob.glob(os.path.join(root, "Family", "cams", "*_cam.txt"))),
                        1.0, 16, 1)
    kw = dict(num_view=3, num_virtual_plane=16, img_height=64, img_width=128, base=32)
    jds = JTanksDataset(root, **kw)
    want = [jds[i] for i in range(3)]
    c_items, py_items = items_both_paths(lambda: TanksDataset(root, **kw), 3, monkeypatch)
    for i in range(3):
        assert_items_equal(c_items[i], want[i], f"C path item {i}")
        assert_items_equal(py_items[i], want[i], f"Python item {i}")
