"""The port's baseline JPEG codec (``rtnr_tpu_torch.data.jpeg`` on the host
library's ``rtnr_jpeg.cpp``) against Pillow, which the JAX package decodes
embedded photos with: ``decode_jpeg`` equals Pillow's decode bit for bit on
baseline 4:4:4, 4:2:2 and 4:2:0 files at two qualities, odd sizes, greyscale
and restart markers; progressive files raise; Pillow decodes
``encode_jpeg``'s files to the port decoder's pixels."""

import io

import numpy as np
import pytest
from PIL import Image

from rtnr_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_size


def _photo(h, w, seed=0):
    """Smooth colour fields with seeded noise: every DCT band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 80 * np.cos(y / 5.0 + x / 11.0),
                     (x * 3 + y * 2) % 256], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("quality", [75, 98])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", [(64, 96), (29, 37), (17, 3)])
def test_decode_equals_pillow(quality, subsampling, size):
    img = _photo(*size, seed=size[0] + quality)
    data = _pil_jpeg(img, quality=quality, subsampling=subsampling)
    got = decode_jpeg(data)
    assert got.shape == (*size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_decode(data))
    assert jpeg_size(data) == (*size, 3)


def test_decode_greyscale_equals_pillow():
    grey = np.asarray(Image.fromarray(_photo(45, 70, seed=3)).convert("L"))
    data = _pil_jpeg(grey, quality=85)
    assert jpeg_size(data) == (45, 70, 1)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_decode(data))


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=3, subsampling="4:2:0"),
                                dict(restart_marker_rows=1, subsampling="4:2:0"),
                                dict(restart_marker_blocks=1, subsampling="4:4:4")])
def test_decode_restart_markers_equals_pillow(kw):
    data = _pil_jpeg(_photo(50, 70, seed=4), quality=90, **kw)
    assert b"\xff\xdd" in data  # a DRI segment: the scan carries RST markers
    np.testing.assert_array_equal(decode_jpeg(data), _pil_decode(data))


def test_decode_full_size_photo_equals_pillow():
    """A 1920x1080 4:2:0 photo at quality 95, the chip check's fixture size."""
    data = _pil_jpeg(_photo(1080, 1920, seed=5), quality=95)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_decode(data))


def test_progressive_raises():
    data = _pil_jpeg(_photo(32, 32), quality=90, progressive=True)
    with pytest.raises(ValueError, match="progressive JPEG is not supported"):
        decode_jpeg(data)


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="no SOI marker"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    data = _pil_jpeg(_photo(32, 32), quality=90)
    with pytest.raises(ValueError, match="truncated JPEG"):
        decode_jpeg(data[:len(data) // 2])


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("size", [(48, 64), (29, 37)])
def test_pillow_decodes_encode_jpeg_to_the_port_bits(subsampling, quality, size):
    img = _photo(*size, seed=9)
    data = encode_jpeg(img, quality=quality, subsampling=subsampling)
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_decode(data))
    # as faithful as libjpeg at the same quality and subsampling
    err = np.abs(got.astype(float) - img).mean()
    ref = _pil_decode(_pil_jpeg(img, quality=quality, subsampling=subsampling))
    assert err <= 1.1 * np.abs(ref.astype(float) - img).mean() + 0.5
