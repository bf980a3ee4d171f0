"""Port vs JAX: the 27-cell cellular basis, the texture samplers of
``ops/sampling.py`` and the demo's two bakes.

Hashes bit-exact and cellular values at atol 1e-6; trilinear, cubemap,
border extension and seamless cubemap sampling at atol 1e-6; the bakes at
a reduced size (16³ shape texture, 32² cubemap faces, full octave counts)
at atol 1e-5.  Inputs come from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.ops import noise as jn
from godot_atmosphere_shader_tpu.ops import sampling as js
from godot_atmosphere_shader_tpu.utils.vecmath import Vec3 as JVec3
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops import noise as tn
from godot_atmosphere_shader_tpu_torch.ops import sampling as ts
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

torch.set_num_threads(1)


def _coords(seed, n=2048, scale=40.0):
    """Float coordinates around the origin, far out (large lattice cells,
    both signs) and on exact integers."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-scale, scale, n), rng.uniform(-3.0e6, 3.0e6, n // 4),
             np.arange(-8, 8, dtype=np.float64)]
    return np.concatenate(parts).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [3, 10, 2**31 + 7])
def test_cellular_hashes_bit_exact(seed):
    x, y, z = (_coords(k).astype(np.int32) for k in (1, 2, 3))
    for dx, dy, dz in ((-1, 0, 1), (1, 1, 1), (0, -1, 0)):
        ref = np.asarray(jn.hash3(jnp.asarray(x) + dx, jnp.asarray(y) + dy,
                                  jnp.asarray(z) + dz, seed))
        got = tn.hash3(_t(x).long() + dx, _t(y).long() + dy, _t(z).long() + dz, seed)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
        np.testing.assert_array_equal(
            tn._mix(got ^ 0xABCD1234).numpy().astype(np.uint32),
            np.asarray(jn._mix(jnp.asarray(ref) ^ jnp.uint32(0xABCD1234))))


@pytest.mark.parametrize("return_type", ["distance", "cell_value", "distance2"])
def test_cellular_noise3_matches_jax(return_type):
    x, y, z = (_coords(k) for k in (4, 5, 6))
    ref = np.asarray(jn.cellular_noise3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                                        seed=5, return_type=return_type))
    got = tn.cellular_noise3(_t(x), _t(y), _t(z), seed=5, return_type=return_type)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_cellular_ridged_bake_spec_matches_jax():
    x, y, z = (_coords(k, n=1024, scale=64.0) for k in (7, 8, 9))
    spec = tdemo.SHAPE_NOISE_BAKE
    ref = np.asarray(jn.sample_noise3(jdemo.SHAPE_NOISE_BAKE, jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(z)))
    got = tn.sample_noise3(spec, _t(x), _t(y), _t(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def _dirs(seed, n=4096):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    d[:, :24] = np.array([[1, -1, 0, 0, 0, 0] * 4, [0, 0, 1, -1, 0, 0] * 4,
                          [0, 0, 0, 0, 1, -1] * 4], np.float64)  # face centers
    d[:, 24:48] = rng.choice([-1.0, 1.0], size=(3, 24))  # cube corners
    return [c.astype(np.float32) for c in d * rng.uniform(0.5, 300.0, n)]


def test_sample_trilinear_repeat_matches_jax():
    rng = np.random.default_rng(11)
    tex = rng.random((16, 8, 32)).astype(np.float32)
    x, y, z = (rng.uniform(-3.0, 3.0, 4096).astype(np.float32) for _ in range(3))
    ref = np.asarray(js.sample_trilinear_repeat(jnp.asarray(tex), jnp.asarray(x),
                                                jnp.asarray(y), jnp.asarray(z)))
    got = ts.sample_trilinear_repeat(_t(tex), _t(x), _t(y), _t(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_cubemap_face_uv_and_bilinear_match_jax():
    rng = np.random.default_rng(12)
    faces = rng.random((6, 24, 24)).astype(np.float32)
    dx, dy, dz = _dirs(13)
    jf, ju, jv = js.cubemap_face_uv(JVec3(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz)))
    tf, tu, tv = ts.cubemap_face_uv(Vec3(_t(dx), _t(dy), _t(dz)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    ref = np.asarray(js.sample_cubemap_bilinear(
        jnp.asarray(faces), JVec3(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz))))
    got = ts.sample_cubemap_bilinear(_t(faces), Vec3(_t(dx), _t(dy), _t(dz)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_extend_borders_and_seamless_match_jax():
    rng = np.random.default_rng(14)
    faces = rng.random((6, 16, 16)).astype(np.float32)
    ref_ext = np.asarray(js.extend_cubemap_borders(jnp.asarray(faces)))
    got_ext = ts.extend_cubemap_borders(_t(faces))
    assert got_ext.shape == (6, 18, 18)
    np.testing.assert_allclose(got_ext.numpy(), ref_ext, rtol=0, atol=1e-6)
    dx, dy, dz = _dirs(15)
    ref = np.asarray(js.sample_cubemap_seamless(
        jnp.asarray(ref_ext), JVec3(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz))))
    got = ts.sample_cubemap_seamless(got_ext, Vec3(_t(dx), _t(dy), _t(dz)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_cubemap_face_dirs_match_jax():
    ref = js.cubemap_face_dirs(8)
    got = ts.cubemap_face_dirs(8, device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-7)


def test_shape_bake_matches_jax_at_16():
    """The seamless 3D bake of the demo's cellular-ridged 8-octave spec."""
    ref = np.asarray(js.bake_noise_texture3d(jdemo.SHAPE_NOISE_BAKE, 16))
    got = ts.bake_noise_texture3d(tdemo.SHAPE_NOISE_BAKE, 16, device="cpu")
    assert got.shape == (16, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_cubemap_bake_matches_jax_at_32():
    """The coverage cubemap bake (warped simplex-smooth FBM, 5 octaves)."""
    ref = np.asarray(js.bake_noise_cubemap(jdemo.COVERAGE_NOISE, jdemo.COVERAGE_SCALE, 32))
    got = ts.bake_noise_cubemap(tdemo.COVERAGE_NOISE, tdemo.COVERAGE_SCALE, 32, device="cpu")
    assert got.shape == (6, 32, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_demo_bake_specs_match_jax():
    assert tdemo.SHAPE_NOISE_BAKE.__dict__ == jdemo.SHAPE_NOISE_BAKE.__dict__
    assert tdemo.COVERAGE_RESOLUTION == jdemo.COVERAGE_RESOLUTION
    assert tdemo.SHAPE_TEXTURE_SIZE == jdemo.SHAPE_TEXTURE_SIZE
