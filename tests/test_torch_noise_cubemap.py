"""The ``NoiseCubemap`` resource: the port's bake against the JAX bake at
atol 1e-6, its deferred regeneration, and the importable atlas PNG."""

import numpy as np

from godot_atmosphere_shader_tpu.models.demo import COVERAGE_NOISE, COVERAGE_SCALE
from godot_atmosphere_shader_tpu.models.noise_cubemap import NoiseCubemap as JCube
from godot_atmosphere_shader_tpu_torch.models.noise_cubemap import NoiseCubemap as TCube
from godot_atmosphere_shader_tpu_torch.ops.noise import NoiseSpec


def test_bake_matches_jax():
    ref = JCube(noise=COVERAGE_NOISE, resolution=24, scale=COVERAGE_SCALE).get_faces()
    port_spec = NoiseSpec(**{k: getattr(COVERAGE_NOISE, k)
                             for k in COVERAGE_NOISE.__dataclass_fields__})
    got = TCube(noise=port_spec, resolution=24, scale=COVERAGE_SCALE, device="cpu").get_faces()
    assert got.shape == (6, 24, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


def test_deferred_regeneration_and_export(tmp_path):
    cm = TCube(resolution=8, device="cpu")
    a = cm.get_faces()
    assert cm.get_faces() is a and cm.generation_count == 1
    cm.resolution = 8  # unchanged: no rebake
    cm.scale = (100.0, 100.0, 100.0)
    assert cm.get_faces() is a and cm.generation_count == 1
    cm.resolution = 9999  # clamped to 4096
    assert cm.resolution == 4096
    cm.resolution = 6
    cm.scale = (50.0, 50.0, 50.0)
    cm.noise = NoiseSpec(seed=4)
    assert cm.get_faces().shape == (6, 6, 6) and cm.generation_count == 2
    png = str(tmp_path / "cov.png")
    side = cm.save_as_image(png)
    assert side == png + ".import"
    from godot_atmosphere_shader_tpu_torch.utils.image_io import read_png, to_uint8

    np.testing.assert_array_equal(read_png(png), to_uint8(cm.generate_importable_image()))
    jcm = JCube(noise=None, resolution=6, scale=(50.0, 50.0, 50.0))
    jcm.noise = type(jcm.noise)(seed=4)
    jpng = str(tmp_path / "jax.png")
    jcm.save_as_image(jpng)
    diff = np.abs(read_png(png).astype(int) - read_png(jpng).astype(int))
    assert diff.max() <= 1
