"""The analytic sun optical depth with its empty quadrature segment dropped.

The chord from a sample point to the shell's exit splits at the ground
crossings into two smooth segments, [s, g0] and [g1, e], and the span below
the ground.  Unless the sun ray crosses the ground ahead of the point,
g0 = g1 and one smooth segment is empty: g0 = g1 = e where the line misses
the ground, = s where the ground lies behind the point.  The plain version
integrates it anyway, to an exact +0, and adds it and the empty span below.
The kernel (``csrc/megakernel.cu::optical_depth_analytic``) evaluates only
the non-empty segment.  On seeded points inside the shell, with sun
directions of each case, a torch mirror that drops the empty segment as the
kernel does gives the port's plain ``optical_depth_analytic`` bit for bit
(``torch.equal``), and both agree with the JAX package's within the
cloud-free tolerance (atol 1e-5, rtol 1e-4).  Geometries: the gas giant's
(R = 1000, H = 25, density 2: optically thick) and the demo moon's
(R = 10, H = 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.ops.optical_depth import optical_depth_analytic as j_od
from godot_atmosphere_shader_tpu.utils import vecmath as jv
from godot_atmosphere_shader_tpu_torch.ops.optical_depth import (gauss_legendre_01,
                                                                 optical_depth_analytic)
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3, clamp

torch.set_num_threads(1)

SHAPE = (32, 64)
GEOMETRIES = {"gas_giant": (1000.0, 25.0, 2.0), "moon": (10.0, 2.0, 1.0)}
CASES = ("misses_ground", "ground_behind", "ground_ahead")


def _points_and_sun(case, radius, height, seed):
    """Seeded points at heights in (0, H] above the ground, and unit sun
    directions at an angle theta from the point's up: near the horizon the
    line misses the ground; pointing up, the ground lies behind the point;
    pointing down, the ray crosses it ahead."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3,) + SHAPE)
    up = u / np.linalg.norm(u, axis=0)
    r = radius + height * (0.02 + 0.98 * rng.random(SHAPE))
    t = rng.normal(size=(3,) + SHAPE)
    t -= (t * up).sum(axis=0) * up
    t /= np.linalg.norm(t, axis=0)
    # the line misses the ground where sin(theta) > R / r
    horizon = np.arcsin(radius / r)
    f = rng.random(SHAPE)
    theta = {"misses_ground": horizon + (np.pi - 2 * horizon) * (0.05 + 0.9 * f),
             "ground_behind": 0.9 * horizon * f,
             "ground_ahead": np.pi - 0.9 * horizon * f}[case]
    d = np.cos(theta) * up + np.sin(theta) * t
    d /= np.linalg.norm(d, axis=0)
    return (up * r).astype(np.float32), d.astype(np.float32)


def _mirror(pos, direction, radius, height, density, quad_points=8):
    """The port's plain optical depth with an empty smooth segment dropped,
    as the kernel evaluates it: where g0 = g1 and at most one smooth segment
    is non-empty, that segment alone (no term added); else the plain sum.
    Returns ``(depth, segments evaluated per point)``."""
    rel = pos
    ra = radius + height
    r = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
    rel = rel * (clamp(r, radius, ra) / torch.clamp(r, min=1e-20))
    b = rel.x * direction.x + rel.y * direction.y + rel.z * direction.z
    c0 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    q2 = torch.clamp(c0 - b * b, min=0.0)
    ha = ra * ra - q2
    shell_hit = ha > 0.0
    sq_a = torch.where(shell_hit, torch.sqrt(torch.where(shell_hit, torch.clamp(ha, min=1e-12),
                                                         1.0)), 0.0)
    s = torch.clamp(-b - sq_a, min=0.0)
    e = torch.where(shell_hit, torch.clamp(-b + sq_a, min=0.0), s)
    hg = radius * radius - q2
    ground_hit = hg > 0.0
    sq_g = torch.where(ground_hit, torch.sqrt(torch.where(ground_hit,
                                                          torch.clamp(hg, min=1e-12), 1.0)), 0.0)
    g0 = clamp(torch.where(ground_hit, -b - sq_g, e), s, e)
    g1 = clamp(torch.where(ground_hit, -b + sq_g, e), s, e)
    dens2 = density * density
    nodes, weights = gauss_legendre_01(quad_points)

    def smooth_segment(a0, a1):
        seg = a1 - a0
        acc = torch.zeros_like(seg)
        for xn, wn in zip(nodes, weights):
            x = a0 + seg * xn + b
            y = 1.0 - torch.clamp((torch.sqrt(x * x + q2) - radius) * (1.0 / height), 0.0, 1.0)
            acc = acc + wn * (y * y * y)
        return acc * seg * dens2

    near, far = s < g0, g1 < e
    single = (g0 == g1) & ~(near & far)
    one = smooth_segment(torch.where(near, s, g1), torch.where(near, g0, e))
    whole = smooth_segment(s, g0) + smooth_segment(g1, e) + (g1 - g0) * dens2
    depth = torch.where(single, torch.where(near | far, one, 0.0), whole)
    segments = torch.where(single, near.int() + far.int(), 2)
    return depth, segments


def _inputs(case, geometry):
    radius, height, density = GEOMETRIES[geometry]
    pos, d = _points_and_sun(case, radius, height, seed=sum(map(ord, case + geometry)))
    return pos, d, radius, height, density


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", CASES)
def test_dropping_the_empty_segment_is_bit_equal(case, geometry):
    """Where the line misses the ground or the ground lies behind the point,
    every point evaluates one segment, and that segment alone equals the
    plain sum bit for bit; where the ray crosses the ground ahead, both."""
    pos, d, radius, height, density = _inputs(case, geometry)
    tpos = Vec3(*(torch.from_numpy(c) for c in pos))
    tdir = Vec3(*(torch.from_numpy(c) for c in d))
    plain = optical_depth_analytic(tpos, tdir, Vec3(0.0, 0.0, 0.0), radius, height, density)
    got, segments = _mirror(tpos, tdir, radius, height, density)
    assert torch.equal(got, plain)
    want = 2 if case == "ground_ahead" else 1
    assert bool((segments == want).all()), torch.unique(segments, return_counts=True)
    assert bool((plain > 0.0).all())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", CASES)
def test_dropping_the_empty_segment_matches_jax(case, geometry):
    """The mirror (and so the plain version) against the JAX package's
    ``optical_depth_analytic`` on the same points: the cloud-free tolerance."""
    pos, d, radius, height, density = _inputs(case, geometry)
    ref = np.asarray(j_od(jv.Vec3(*(jnp.asarray(c) for c in pos)),
                          jv.Vec3(*(jnp.asarray(c) for c in d)), jv.Vec3(0.0, 0.0, 0.0),
                          radius, height, density))
    got, _ = _mirror(Vec3(*(torch.from_numpy(c) for c in pos)),
                     Vec3(*(torch.from_numpy(c) for c in d)), radius, height, density)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
