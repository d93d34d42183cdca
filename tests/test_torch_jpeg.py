"""The port's JPEG codec (``pointmvsnet_tpu_torch/dataset/jpeg.py``) against
cv2's libjpeg: files cv2 writes, read by ``read_jpeg`` and by
``cv2.imread`` + BGR→RGB, at 4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey, quality
50 / 95 / 100, two sizes that are not multiples of the MCU or are, and
with restart markers; files ``write_jpeg`` writes, read by cv2.

Bars: max |Δ| ≤ 1 level for grey and 4:4:4 and ≤ 2 levels where chroma is
subsampled (the reader follows libjpeg's islow IDCT, fancy upsampling and
colour tables, so bit-equality is expected and the share of pixels that
differ is printed). The writer's PSNR against the source is within 3 dB
of cv2's at quality 95."""

import cv2
import numpy as np
import pytest

from pointmvsnet_tpu_torch.dataset import io, jpeg
from pointmvsnet_tpu_torch.dataset.synthetic import _texture
from torch_threads import one_torch_thread  # noqa: F401

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def image(h, w, seed=0):
    """A smooth texture with pixel noise, like the synthetic scenes."""
    return _texture(np.random.RandomState(seed), h, w)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def assert_within(got, want, bar, what):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    print(f"{what}: max |Δ| {d.max()}, {100 * (d > 0).mean():.3f}% of values differ")
    assert got.shape == want.shape and got.dtype == np.uint8
    assert d.max() <= bar, what


@pytest.mark.parametrize("size", [(37, 53), (64, 80)])
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "grey"])
def test_read_jpeg_equals_cv2(tmp_path, sampling, quality, size):
    x = image(*size, seed=quality)
    path = str(tmp_path / "x.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling == "grey":
        cv2.imwrite(path, cv2.cvtColor(x, cv2.COLOR_RGB2GRAY), params)
    else:
        cv2.imwrite(path, x[..., ::-1], params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                  SAMPLING[sampling]])
    bar = 1 if sampling in ("444", "grey") else 2
    assert_within(io.read_jpeg(path), cv2_rgb(path), bar, f"{sampling} q{quality} {size}")


@pytest.mark.parametrize("interval", [1, 3])
def test_read_jpeg_restart_markers(tmp_path, interval):
    path = str(tmp_path / "r.jpg")
    cv2.imwrite(path, image(37 * 3, 53 * 3)[..., ::-1], [cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    with open(path, "rb") as f:
        assert b"\xff\xdd" in f.read()                  # a DRI segment was written
    assert_within(io.read_jpeg(path), cv2_rgb(path), 2, f"restart interval {interval}")


def test_read_jpeg_rejects_progressive(tmp_path):
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, image(64, 64)[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        io.read_jpeg(path)


def test_read_jpeg_rejects_non_jpeg_and_truncated(tmp_path):
    path = str(tmp_path / "t.jpg")
    cv2.imwrite(path, image(32, 48)[..., ::-1])
    data = open(path, "rb").read()
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG" + data)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data[:len(data) // 2])


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("size", [(64, 80), (37, 53), (128, 160)])
def test_write_jpeg_against_cv2(tmp_path, size):
    x = image(*size, seed=7)
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "theirs.jpg")
    io.write_jpeg(ours, x)
    cv2.imwrite(theirs, x[..., ::-1])                  # cv2's default: quality 95, 4:2:0
    decoded = cv2_rgb(ours)
    p_ours, p_cv2 = psnr(decoded, x), psnr(cv2_rgb(theirs), x)
    print(f"{size}: PSNR write_jpeg {p_ours:.2f} dB, cv2 {p_cv2:.2f} dB")
    assert p_ours >= p_cv2 - 3.0
    assert_within(io.read_jpeg(ours), decoded, 2, f"write_jpeg {size} read back")


def test_write_jpeg_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError):
        io.write_jpeg(str(tmp_path / "x.jpg"), np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        io.write_jpeg(str(tmp_path / "x.jpg"), np.zeros((8, 8, 3), np.float32))


def test_read_image_picks_the_format(tmp_path):
    x = image(32, 48)
    png, jpg, other = (str(tmp_path / n) for n in ("a.png", "b.jpg", "c.bin"))
    io.write_png(png, x)
    io.write_jpeg(jpg, x)
    np.testing.assert_array_equal(io.read_image(png), x)
    np.testing.assert_array_equal(io.read_image(jpg), io.read_jpeg(jpg))
    with open(other, "wb") as f:
        f.write(b"GIF89a" + bytes(16))
    with pytest.raises(ValueError, match="neither"):
        io.read_image(other)
