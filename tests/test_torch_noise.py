"""Port vs JAX: the lattice noise of ``godot_atmosphere_shader_tpu_torch``.

Hashes must agree bit for bit (the uint32 arithmetic is emulated in int64
on the torch side); every noise basis at atol 1e-6 and the full pipelines
(domain warp + every fractal, weighted or not) at atol 1e-5, on the same
seeded inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.ops import noise as jn
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops import noise as tn

torch.set_num_threads(1)


def _lattice_coords(seed, n=4096):
    """int32 lattice coordinates: small, negative, large and the extremes."""
    rng = np.random.default_rng(seed)
    parts = [rng.integers(-300, 300, n), rng.integers(-2**31, 2**31 - 1, n),
             np.array([0, -1, 1, 2**31 - 1, -2**31, -2**30, 2**30, 12345])]
    return np.concatenate(parts).astype(np.int32)


def _u32(t):
    """Port hash (int64 holding a uint32) → numpy uint32."""
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 77, 1293384])
def test_hash3_bit_exact(seed):
    ix, iy, iz = (_lattice_coords(k) for k in (1, 2, 3))
    ref = np.asarray(jn.hash3(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), seed))
    got = tn.hash3(torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(iz), seed)
    np.testing.assert_array_equal(_u32(got), ref)


@pytest.mark.parametrize("seed", [3, 11 + 1293373, 2**32 - 5])
def test_corner_hashes_bit_exact(seed):
    ix, iy, iz = (_lattice_coords(k) for k in (4, 5, 6))
    ref = jn._corner_hashes(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), seed)
    got = tn._corner_hashes(torch.from_numpy(ix), torch.from_numpy(iy),
                            torch.from_numpy(iz), seed)
    assert len(got) == 8
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_u32(g), np.asarray(r))


def test_hash_bit_conversions_exact():
    rng = np.random.default_rng(7)
    h = np.concatenate([rng.integers(0, 2**32, 8192, dtype=np.uint64),
                        [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    hj, ht = jnp.asarray(h), torch.from_numpy(h.astype(np.int64))
    np.testing.assert_array_equal(_u32(tn._mix(ht)), np.asarray(jn._mix(hj)))
    np.testing.assert_array_equal(_u32(tn._mix_fast(ht)), np.asarray(jn._mix_fast(hj)))
    np.testing.assert_array_equal(tn._full_to_signed(ht).numpy(),
                                  np.asarray(jn._full_to_signed(hj)))
    np.testing.assert_array_equal(tn._hash_to_unit(ht).numpy(),
                                  np.asarray(jn._hash_to_unit(hj)))
    for shift in (0, 10, 20):
        np.testing.assert_array_equal(tn._bits_to_signed(ht, shift).numpy(),
                                      np.asarray(jn._bits_to_signed(hj, shift)))


def _points(seed, n=(32, 48), scale=40.0):
    rng = np.random.default_rng(seed)
    return [(rng.random(n, dtype=np.float32) * 2.0 - 1.0) * np.float32(scale)
            for _ in range(3)]


@pytest.mark.parametrize("seed", [0, 5])
def test_value_noise3(seed):
    x, y, z = _points(seed)
    ref = np.asarray(jn.value_noise3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), seed))
    got = tn.value_noise3(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), seed)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [1011, 1012])
def test_value_noise3_vec3(seed):
    x, y, z = _points(seed, scale=500.0)
    ref = jn.value_noise3_vec3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), seed)
    got = tn.value_noise3_vec3(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(z), seed)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [11, 11 + 4])
def test_simplex_smooth_noise3(seed):
    x, y, z = _points(seed, scale=8.0)
    ref = np.asarray(jn.simplex_smooth_noise3(jnp.asarray(x), jnp.asarray(y),
                                              jnp.asarray(z), seed))
    got = tn.simplex_smooth_noise3(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(z), seed)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_noise_spec_matches_jax():
    names = [f.name for f in dataclasses.fields(jn.NoiseSpec)]
    assert [f.name for f in dataclasses.fields(tn.NoiseSpec)] == names
    assert dataclasses.asdict(tn.NoiseSpec()) == dataclasses.asdict(jn.NoiseSpec())
    for name in ("COVERAGE_NOISE", "SHAPE_NOISE_FAST", "SHAPE_NOISE_FAST_CELL",
                 "SHAPE_NOISE_BAKE"):
        assert (dataclasses.asdict(getattr(tdemo, name))
                == dataclasses.asdict(getattr(jdemo, name)))


@pytest.mark.parametrize("name,scale", [("COVERAGE_NOISE", 200.0),
                                        ("SHAPE_NOISE_FAST", 700.0),
                                        ("SHAPE_NOISE_FAST_CELL", 700.0)])
def test_sample_noise3_demo_specs(name, scale):
    """The demo's coverage (warped simplex-smooth FBM at NoiseCubemap scale)
    and shape (ridged value noise, or the cellular tier's 8-cell Worley,
    at texture scale) pipelines."""
    x, y, z = _points(21, n=(24, 32), scale=scale)
    ref = np.asarray(jn.sample_noise3(getattr(jdemo, name), jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(z)))
    got = tn.sample_noise3(getattr(tdemo, name), torch.from_numpy(x),
                           torch.from_numpy(y), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("basis,kw", [
    ("perlin_noise3", {}), ("simplex_noise3", {}), ("cellular_noise3_fast", {}),
    ("cellular_noise3", dict(return_type="distance2")),
    ("cellular_noise3", dict(return_type="cell_value", jitter=0.6)),
], ids=["perlin", "simplex", "cellular_fast", "cellular_distance2", "cellular_cell_value"])
@pytest.mark.parametrize("seed", [3, 1293384])
def test_noise_bases_match_jax(basis, kw, seed):
    x, y, z = _points(seed + 40, scale=40.0)
    ref = np.asarray(getattr(jn, basis)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), seed,
                                        **kw))
    got = getattr(tn, basis)(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z),
                             seed, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec", [
    dict(noise_type="value", fractal_type="ping_pong"),
    dict(noise_type="cellular", fractal_type="ping_pong", ping_pong_strength=2.5),
    dict(noise_type="value", weighted_strength=0.5),
    dict(noise_type="perlin", fractal_type="ridged", weighted_strength=0.7),
    dict(noise_type="simplex", fractal_type="ping_pong", weighted_strength=0.4),
    dict(noise_type="cellular_fast", fractal_type="ridged", octaves=3, gain=0.665),
    dict(noise_type="simplex", fractal_type="none", warp_enabled=True, warp_octaves=2),
], ids=["ping_pong", "cellular_ping_pong", "fbm_weighted", "ridged_weighted",
        "ping_pong_weighted", "cellular_fast_ridged", "simplex_warped"])
def test_fractal_pipelines_match_jax(spec):
    """Ping-pong and weighted_strength under fbm, ridged and ping-pong
    (the amplitude then a per-sample f32 chain), through sample_noise3."""
    js = jn.NoiseSpec(**{"frequency": 0.2, "seed": 9, "octaves": 4, **spec})
    x, y, z = _points(33, n=(24, 32), scale=60.0)
    ref = np.asarray(jn.sample_noise3(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    got = tn.sample_noise3(tn.NoiseSpec(**dataclasses.asdict(js)), torch.from_numpy(x),
                           torch.from_numpy(y), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ret", ["distance2", "cell_value"])
def test_cellular_fast_refuses_the_f2_returns(ret):
    """As in JAX: the 8-cell window has no usable F2."""
    x = torch.zeros(2, 2)
    with pytest.raises(ValueError):
        tn.cellular_noise3_fast(x, x, x, return_type=ret)
    with pytest.raises(ValueError):
        tn.sample_noise3(tn.NoiseSpec(noise_type="cellular_fast", cellular_return=ret), x, x, x)
