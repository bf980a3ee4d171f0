"""Port vs JAX: the texture-mode samplers (kernel K2) and their pyramids.

The pyramids are built by the port's own numpy copies and must equal the
JAX package's array for array, with equal ``TexMeta``s (the lat-long base
level, resampled through each package's seamless cubemap sampler, at atol
1e-6).  The port's plain samplers are held against the JAX samplers run
through an interpret-mode ``pl.pallas_call`` harness (as
``tests/test_texsample.py`` runs them) on the same ``(8..16, 128)`` planes,
one batch per call, in every mode, at the JAX test's atol 2e-6; each case
also asserts the level and mode the plain version chose.  On the CPU the
K2-alone wrapper ``megakernel.sample_batches`` is the plain version; the
card runs the kernel against it (``chip_smoke.py``, ``test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from godot_atmosphere_shader_tpu.ops.pallas import texsample as jts
from godot_atmosphere_shader_tpu.utils.vecmath import Vec3 as JVec3
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as tts
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

torch.set_num_threads(1)


def _jax_tex3d(data, meta, x, y, z, window_rows=16, band_rows=16, band_max_slices=32):
    def kern(tab_ref, x_ref, y_ref, z_ref, o_ref):
        o_ref[:] = jts.sample_tex3d(tab_ref, meta, x_ref[:], y_ref[:], z_ref[:],
                                    window_rows=window_rows, band_rows=band_rows,
                                    band_max_slices=band_max_slices)

    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True,
    )(jnp.asarray(data), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))


def _jax_latlong(data, meta, d, window_rows=16):
    def kern(tab_ref, dx_ref, dy_ref, dz_ref, o_ref):
        o_ref[:] = jts.sample_latlong(tab_ref, meta, JVec3(dx_ref[:], dy_ref[:], dz_ref[:]),
                                      window_rows=window_rows)

    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(d[0].shape, jnp.float32), interpret=True,
    )(jnp.asarray(data), *(jnp.asarray(c) for c in d)))


def _meta(jmeta):
    return tts.TexMeta(**dataclasses.asdict(jmeta))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(5)
    out = {}
    for s in (32, 64):
        tex = rng.random((s, s, s)).astype(np.float32)
        jdata, jmeta = jts.build_tex3d_pyramid(tex)
        out[s] = (tex, np.asarray(jdata), jmeta)
    return out


@pytest.mark.parametrize("size", [8, 32, 64])
def test_tex3d_pyramid_equals_jax(size):
    tex = np.random.default_rng(size).random((size,) * 3).astype(np.float32)
    jdata, jmeta = jts.build_tex3d_pyramid(tex)
    data, meta = tts.build_tex3d_pyramid(tex)
    np.testing.assert_array_equal(data, np.asarray(jdata))
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    assert meta.floor_level(16) == jmeta.floor_level(16)
    assert meta.floor_level(48) == jmeta.floor_level(48)


def test_latlong_pyramid_matches_jax():
    faces = np.random.default_rng(6).random((6, 32, 32)).astype(np.float32)
    jdata, jmeta = jts.build_latlong_pyramid(faces, width=128)
    data, meta = tts.build_latlong_pyramid(faces, width=128)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    np.testing.assert_allclose(data, np.asarray(jdata), rtol=0, atol=1e-6)
    dirs_j, dirs_t = jts.latlong_dirs(16, 32), tts.latlong_dirs(16, 32)
    for a, b in zip(dirs_j, dirs_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("bad", [(48, 48, 48), (4, 4, 4), (8, 16, 16), (256, 256, 256)])
def test_unpackable_shape_textures_raise(bad):
    with pytest.raises(ValueError):
        tts.build_tex3d_pyramid(np.zeros(bad, np.float32))


def test_unpackable_cubemaps_raise():
    with pytest.raises(ValueError):
        tts.build_latlong_pyramid(np.zeros((6, 8, 8), np.float32), width=96)
    with pytest.raises(ValueError):
        tts.build_latlong_pyramid(np.zeros((5, 8, 8), np.float32))


def _planes(rng, lo, ext, rows=16):
    return [(lo[a] + ext[a] * rng.random((rows, 128))).astype(np.float32) for a in range(3)]


# (name, texture size, lo, extent, rows, sampler kwargs, expected (mode, level))
TEX3D_CASES = [
    ("windowed_level0", 32, (0.47, 0.52, 0.31), (0.06, 0.06, 0.06), 16,
     dict(window_rows=48, band_rows=0), (tts.WINDOWED, 0)),
    ("minified", 64, (0.1, 0.1, 0.1), (0.35, 0.35, 0.35), 16,
     dict(window_rows=48, band_rows=0), (tts.WINDOWED, 2)),
    ("banded", 64, (20.2 / 64, 33.1 / 64, 11.4 / 64), (3.0 / 64, 3.0 / 64, 5.0 / 64), 16,
     dict(window_rows=16, band_rows=16), (tts.BANDED, 0)),
    ("slice_cap_declines", 64, (10.0 / 64, 10.0 / 64, 0.05), (2.0 / 64, 2.0 / 64, 0.4), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=8), (tts.WINDOWED, 2)),
    ("floor_on_straddle", 32, (0.95, 0.4, 0.6), (0.1, 0.05, 0.05), 16,
     dict(window_rows=48, band_rows=0), (tts.FLOOR, 1)),
    ("demo_settings_floor", 64, (0.3, 0.9, 0.2), (0.2, 0.2, 0.2), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=32), (tts.FLOOR, 2)),
]


@pytest.mark.parametrize("case", TEX3D_CASES, ids=[c[0] for c in TEX3D_CASES])
def test_plain_tex3d_matches_jax_interpret(pyramids, case):
    name, size, lo, ext, rows, kw, (mode, level) = case
    _, jdata, jmeta = pyramids[size]
    x, y, z = _planes(np.random.default_rng(sum(map(ord, name))), lo, ext, rows)
    ref = _jax_tex3d(jdata, jmeta, x, y, z, **kw)
    got, got_mode, got_level = tts.sample_tex3d(_t(jdata), _meta(jmeta), _t(x), _t(y), _t(z),
                                                return_choice=True, **kw)
    assert (got_mode, got_level) == (mode, level)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_banded_slice_cap_equals_band_off(pyramids):
    """A footprint over more z-slices than the cap takes the windowed path
    as if banding were off."""
    _, jdata, jmeta = pyramids[64]
    x, y, z = _planes(np.random.default_rng(9), (10.0 / 64, 10.0 / 64, 0.05),
                      (2.0 / 64, 2.0 / 64, 0.4), 8)
    on = tts.sample_tex3d(_t(jdata), _meta(jmeta), _t(x), _t(y), _t(z), window_rows=16,
                          band_rows=16, band_max_slices=8)
    off = tts.sample_tex3d(_t(jdata), _meta(jmeta), _t(x), _t(y), _t(z), window_rows=16,
                           band_rows=0)
    np.testing.assert_array_equal(on.numpy(), off.numpy())


def _directions(rng, theta0, phi0, span, rows=16):
    theta = (theta0 + span * rng.random((rows, 128))).astype(np.float32)
    phi = (phi0 + span * rng.random((rows, 128))).astype(np.float32)
    d = [np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta)]
    return [c.astype(np.float32) for c in d]


LATLONG_CASES = [
    ("windowed", (0.3, 0.2, 0.02), (tts.WINDOWED, 0)),
    ("windowed_minified", (0.3, 0.2, 0.3), (tts.WINDOWED, 2)),
    ("floor_on_seam", (np.pi - 0.05, -0.1, 0.1), (tts.FLOOR, 3)),
]


@pytest.fixture(scope="module")
def latlong():
    faces = np.random.default_rng(8).random((6, 64, 64)).astype(np.float32)
    jdata, jmeta = jts.build_latlong_pyramid(faces, width=512)
    return np.asarray(jdata), jmeta


@pytest.mark.parametrize("case", LATLONG_CASES, ids=[c[0] for c in LATLONG_CASES])
def test_plain_latlong_matches_jax_interpret(latlong, case):
    name, (theta0, phi0, span), (mode, level) = case
    jdata, jmeta = latlong
    d = _directions(np.random.default_rng(len(name)), theta0, phi0, span)
    ref = _jax_latlong(jdata, jmeta, d)
    got, got_mode, got_level = tts.sample_latlong(_t(jdata), _meta(jmeta), Vec3(*map(_t, d)),
                                                  return_choice=True)
    assert (got_mode, got_level) == (mode, level)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_poly_trig_matches_compiled_jax():
    """The polynomial atan2/asin and the (u, v) map, bit for bit as the
    compiled JAX samplers (multiply-adds fused) compute them."""
    rng = np.random.default_rng(4)
    y, x = (rng.normal(size=8192).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        tts.atan2_poly(_t(y), _t(x)).numpy(),
        np.asarray(jax.jit(jts.atan2_poly)(jnp.asarray(y), jnp.asarray(x))))
    s = rng.uniform(-1.2, 1.2, 8192).astype(np.float32)
    np.testing.assert_array_equal(tts.asin_poly(_t(s)).numpy(),
                                  np.asarray(jax.jit(jts.asin_poly)(jnp.asarray(s))))
    d = _directions(rng, -3.0, -1.5, 3.0)

    def uv(dx, dy, dz):
        return (jts.atan2_poly(dz, dx) * (1.0 / (2.0 * np.pi)) + 0.5,
                0.5 - jts.asin_poly(dy) * (1.0 / np.pi))

    for got, ref in zip(tts.latlong_uv(Vec3(*map(_t, d))), jax.jit(uv)(*map(jnp.asarray, d))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_batched_form_is_per_batch(pyramids):
    """Knot planes (G, rows, W) cut into rows×128 batches: each batch is
    sampled as one JAX call on its own stacked plane would sample it."""
    _, jdata, jmeta = pyramids[64]
    rng = np.random.default_rng(10)
    g, rows, br = 2, 16, 8
    lo = rng.uniform(0.05, 0.35, (3, rows // br, 2))
    ext = np.where(rng.random((3, rows // br, 2)) < 0.5, 0.02, 0.6)
    ext[:, 0, 0], ext[:, 1, 1] = 0.02, 0.7  # one compact batch, one that wraps
    planes = []
    for a in range(3):
        p = np.empty((g, rows, 256), np.float32)
        for i in range(rows // br):
            for j in range(2):
                p[:, i * br:(i + 1) * br, j * 128:(j + 1) * 128] = (
                    lo[a, i, j] + ext[a, i, j] * rng.random((g, br, 128)))
        planes.append(p)
    got = tts.sample_tex3d_batched(_t(jdata), _meta(jmeta), *map(_t, planes), br).numpy()
    modes = set()
    for i in range(rows // br):
        for j in range(2):
            blk = [p[:, i * br:(i + 1) * br, j * 128:(j + 1) * 128].reshape(g * br, 128)
                   for p in planes]
            ref = _jax_tex3d(jdata, jmeta, *blk)
            np.testing.assert_allclose(
                got[:, i * br:(i + 1) * br, j * 128:(j + 1) * 128].reshape(g * br, 128),
                ref, rtol=0, atol=2e-6)
            modes.add(tts.sample_tex3d(_t(jdata), _meta(jmeta), *map(_t, blk),
                                       return_choice=True)[1])
    assert tts.FLOOR in modes and len(modes) > 1


def test_k2_wrapper_on_cpu_is_the_plain_version(pyramids, latlong):
    _, jdata, jmeta = pyramids[64]
    x, y, z = _planes(np.random.default_rng(2), (0.3, 0.3, 0.3), (0.1, 0.2, 0.05), 8)
    a, b, c = (_t(p.reshape(2, -1)) for p in (x, y, z))
    mk.counters.reset()
    out, mode, level = mk.sample_batches(_t(jdata), _meta(jmeta), a, b, c)
    assert mk.counters.texsample_launches == 0
    for i in range(2):
        ref, m, lv = tts.sample_tex3d(_t(jdata), _meta(jmeta), a[i], b[i], c[i],
                                      return_choice=True)
        np.testing.assert_array_equal(out[i].numpy(), ref.numpy())
        assert (int(mode[i]), int(level[i])) == (m, lv)
    ldata, lmeta = latlong
    d = [_t(p.reshape(2, -1)) for p in _directions(np.random.default_rng(3), 0.3, 0.2, 0.02, 8)]
    out, mode, _ = mk.sample_batches(_t(ldata), _meta(lmeta), *d)
    ref = tts.sample_latlong(_t(ldata), _meta(lmeta), Vec3(*(p[1] for p in d)))
    np.testing.assert_array_equal(out[1].numpy(), ref.numpy())
