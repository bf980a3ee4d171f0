"""Image export: the port's PNG codec, atlas and ``.import`` sidecar
against the JAX package's, byte for byte."""

import numpy as np
import pytest

from godot_atmosphere_shader_tpu.utils import image_io as jio
from godot_atmosphere_shader_tpu_torch.utils import image_io as tio


@pytest.mark.parametrize("shape", [(7, 9), (5, 11, 3), (6, 4, 4)])
def test_png_bytes_equal_jax(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    tio.write_png(str(tmp_path / "port.png"), img)
    jio.write_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "port.png")), img)
    rgb = tio.read_image_rgb(str(tmp_path / "port.png"))
    assert rgb.shape == shape[:2] + (3,) and rgb.dtype == np.uint8


def test_to_uint8_and_refusals(tmp_path):
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tio.to_uint8(x), jio.to_uint8(x))
    with pytest.raises(ValueError):
        tio.write_png(str(tmp_path / "f.png"), x)
    with pytest.raises(ValueError):  # neither PNG nor decodable without PIL here
        path = tmp_path / "sky.webp"
        path.write_bytes(b"RIFF0000WEBP")
        try:
            import PIL  # noqa: F401
        except ImportError:
            tio.read_image_rgb(str(path))
        else:
            raise ValueError("PIL present: the refusal is not reachable")


def test_atlas_and_sidecar(tmp_path):
    faces = np.random.default_rng(2).random((6, 5, 5), dtype=np.float32)
    atlas = tio.cubemap_atlas(faces)
    np.testing.assert_array_equal(atlas, jio.cubemap_atlas(faces))
    assert atlas.shape == (10, 15)
    np.testing.assert_array_equal(tio.atlas_to_cubemap(atlas), faces)
    png = str(tmp_path / "cov.png")
    side = tio.write_import_file(png)
    assert side == png + ".import"
    text = open(side).read()
    assert 'source_file="res://cov.png"' in text and "slices/arrangement=1" in text
    assert text == jio._IMPORT_TEMPLATE.format(name="cov.png")
