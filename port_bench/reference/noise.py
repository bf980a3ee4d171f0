"""Procedural 3D noise on torch tensors, bit-compatible with the JAX package.

Counterpart of ``godot_atmosphere_shader_tpu/ops/noise.py``: integer lattice
hashing plus interpolation, recomputed at every sample.  The lattice hash is
uint32 arithmetic (wrap-around multiplies, logical shifts).  torch has no
usable uint32, so hashes are carried in int64 tensors holding the uint32 bit
pattern: every multiply is split into 16-bit halves so no intermediate
leaves int64 range, and results are masked back to 32 bits.  The CUDA
megakernel uses ``uint32_t`` natively; both agree bit for bit with JAX.

Every basis (``value``, ``perlin``, ``simplex``, ``simplex_smooth``, the
27-cell ``cellular`` and the 8-cell ``cellular_fast``), every fractal
(``none``, ``fbm``, ``ridged``, ``ping_pong``, each with
``weighted_strength``) and the domain warp.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK32 = 0xFFFFFFFF


def _u32(i: torch.Tensor) -> torch.Tensor:
    """int32 lattice coordinate → int64 holding its uint32 bit pattern."""
    return i.to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """``(a · c) mod 2³²`` for ``a`` in ``[0, 2³²)`` and ``c`` an int or an
    int64 tensor of uint32 values, without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _add32(a: torch.Tensor, c) -> torch.Tensor:
    return (a + c) & _MASK32


def _mix(h):
    """murmur3-style avalanche on uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _mix_fast(h):
    """:func:`_mix` without the final xor-shift."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h


def hash3(ix, iy, iz, seed: int):
    """Hash int32 lattice coordinates to a uint32 (in an int64 tensor)."""
    h = (_mul32(_u32(ix), 0x9E3779B1) + _mul32(_u32(iy), 0x85EBCA77)
         + _mul32(_u32(iz), 0xC2B2AE3D) + (seed & _MASK32)) & _MASK32
    return _mix(h)


def _hash_to_unit(h):
    """uint32 → float32 in [0, 1) from the top 24 bits."""
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _hash_to_signed(h):
    """uint32 → float32 in [-1, 1)."""
    return _hash_to_unit(h) * 2.0 - 1.0


def _full_to_signed(h):
    """uint32 → float in [-1, 1): bit-identical int32 reinterpretation."""
    s = torch.where(h >= 0x80000000, h - 0x100000000, h)
    return s.to(torch.float32) * (2.0 ** -31)


def _bits_to_signed(h, shift):
    """10-bit field of a hash → float in [-1, 1)."""
    return ((h >> shift) & 1023).to(torch.float32) * (1.0 / 512.0) - 1.0


def _floor_int(x):
    f = torch.floor(x)
    return f.to(torch.int32), x - f


def _cubic(t):
    """C1 smoothstep fade."""
    return t * t * (3.0 - 2.0 * t)


def _quintic(t):
    """Perlin's C2 fade curve."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _corner_hashes(ix, iy, iz, seed: int):
    """The 8 lattice-corner hashes with the coordinate multiplies hoisted.
    Corners ordered c000, c100, c010, c110, c001, c101, c011, c111."""
    hx0 = _mul32(_u32(ix), 0x9E3779B1)
    hy0 = _mul32(_u32(iy), 0x85EBCA77)
    hz0 = _add32(_mul32(_u32(iz), 0xC2B2AE3D), seed & _MASK32)
    hx1 = _add32(hx0, 0x9E3779B1)
    hy1 = _add32(hy0, 0x85EBCA77)
    hz1 = _add32(hz0, 0xC2B2AE3D)

    def h(a, b, c):
        return _mix_fast((a + b + c) & _MASK32)

    return (h(hx0, hy0, hz0), h(hx1, hy0, hz0), h(hx0, hy1, hz0),
            h(hx1, hy1, hz0), h(hx0, hy0, hz1), h(hx1, hy0, hz1),
            h(hx0, hy1, hz1), h(hx1, hy1, hz1))


def value_noise3(x, y, z, seed: int = 0):
    """Trilinear value noise in [-1, 1] (8 hashes)."""
    ix, fx = _floor_int(x)
    iy, fy = _floor_int(y)
    iz, fz = _floor_int(z)
    ux, uy, uz = _cubic(fx), _cubic(fy), _cubic(fz)
    c000, c100, c010, c110, c001, c101, c011, c111 = (
        _full_to_signed(h) for h in _corner_hashes(ix, iy, iz, seed))
    x00 = c000 + (c100 - c000) * ux
    x10 = c010 + (c110 - c010) * ux
    x01 = c001 + (c101 - c001) * ux
    x11 = c011 + (c111 - c011) * ux
    y0 = x00 + (x10 - x00) * uy
    y1 = x01 + (x11 - x01) * uy
    return y0 + (y1 - y0) * uz


def value_noise3_vec3(x, y, z, seed: int = 0):
    """Three decorrelated value-noise channels from one lattice pass (three
    10-bit fields of each corner hash)."""
    ix, fx = _floor_int(x)
    iy, fy = _floor_int(y)
    iz, fz = _floor_int(z)
    ux, uy, uz = _cubic(fx), _cubic(fy), _cubic(fz)

    def trilerp(c):
        x00 = c[0] + (c[1] - c[0]) * ux
        x10 = c[2] + (c[3] - c[2]) * ux
        x01 = c[4] + (c[5] - c[4]) * ux
        x11 = c[6] + (c[7] - c[6]) * ux
        y0 = x00 + (x10 - x00) * uy
        y1 = x01 + (x11 - x01) * uy
        return y0 + (y1 - y0) * uz

    hs = _corner_hashes(ix, iy, iz, seed)
    return tuple(trilerp([_bits_to_signed(h, s) for h in hs])
                 for s in (0, 10, 20))


def _grad_dot(h, fx, fy, fz):
    """Gradient dot product from three disjoint 10-bit fields of one hash."""
    return (_bits_to_signed(h, 0) * fx + _bits_to_signed(h, 10) * fy
            + _bits_to_signed(h, 20) * fz)


_CORNER_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                   (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def perlin_noise3(x, y, z, seed: int = 0):
    """Gradient (Perlin-style) noise in ≈[-1, 1] (8 hoisted hashes)."""
    ix, fx = _floor_int(x)
    iy, fy = _floor_int(y)
    iz, fz = _floor_int(z)
    ux, uy, uz = _quintic(fx), _quintic(fy), _quintic(fz)
    c000, c100, c010, c110, c001, c101, c011, c111 = (
        _grad_dot(h, fx - dx, fy - dy, fz - dz)
        for h, (dx, dy, dz) in zip(_corner_hashes(ix, iy, iz, seed), _CORNER_OFFSETS))
    x00 = c000 + (c100 - c000) * ux
    x10 = c010 + (c110 - c010) * ux
    x01 = c001 + (c101 - c001) * ux
    x11 = c011 + (c111 - c011) * ux
    y0 = x00 + (x10 - x00) * uy
    y1 = x01 + (x11 - x01) * uy
    return (y0 + (y1 - y0) * uz) * 1.15


_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0


def simplex_noise3(x, y, z, seed: int = 0):
    """3D simplex noise in ≈[-1, 1], branch-free corner ranking (ties
    broken x > y > z)."""
    s = (x + y + z) * _F3
    ix, _ = _floor_int(x + s)
    iy, _ = _floor_int(y + s)
    iz, _ = _floor_int(z + s)
    t = (ix + iy + iz).to(torch.float32) * _G3
    x0 = x - (ix.to(torch.float32) - t)
    y0 = y - (iy.to(torch.float32) - t)
    z0 = z - (iz.to(torch.float32) - t)
    i32 = torch.int32
    rank_x = (x0 < y0).to(i32) + (x0 < z0).to(i32)
    rank_y = (x0 >= y0).to(i32) + (y0 < z0).to(i32)
    rank_z = (x0 >= z0).to(i32) + (y0 >= z0).to(i32)
    i1, j1, k1 = ((r == 0).to(i32) for r in (rank_x, rank_y, rank_z))
    i2, j2, k2 = ((r <= 1).to(i32) for r in (rank_x, rank_y, rank_z))
    f32 = torch.float32
    x1, y1, z1 = x0 - i1.to(f32) + _G3, y0 - j1.to(f32) + _G3, z0 - k1.to(f32) + _G3
    x2 = x0 - i2.to(f32) + 2.0 * _G3
    y2 = y0 - j2.to(f32) + 2.0 * _G3
    z2 = z0 - k2.to(f32) + 2.0 * _G3
    x3, y3, z3 = x0 - 1.0 + 3.0 * _G3, y0 - 1.0 + 3.0 * _G3, z0 - 1.0 + 3.0 * _G3

    def corner(cx, cy, cz, di, dj, dk):
        tt = torch.clamp(0.6 - cx * cx - cy * cy - cz * cz, min=0.0)
        tt = tt * tt
        return tt * tt * _grad_dot(hash3(ix + di, iy + dj, iz + dk, seed), cx, cy, cz)

    n = (corner(x0, y0, z0, 0, 0, 0) + corner(x1, y1, z1, i1, j1, k1)
         + corner(x2, y2, z2, i2, j2, k2) + corner(x3, y3, z3, 1, 1, 1))
    return n * 32.0


_R3 = 2.0 / 3.0
_LATTICE2_SALT = 1293373
_OS2S_NORM = 7.3


def simplex_smooth_noise3(x, y, z, seed: int = 0):
    """OpenSimplex2S-style noise (FastNoiseLite's default type): two cubic
    sub-lattices of a BCC lattice, 16 clamped ``(0.75 − d²)⁴ · grad·d``
    kernels, all evaluated branch-free."""
    r = (x + y + z) * _R3
    xr, yr, zr = r - x, r - y, r - z
    ix, fx = _floor_int(xr)
    iy, fy = _floor_int(yr)
    iz, fz = _floor_int(zr)

    def lattice_sum(jx, jy, jz, gx, gy, gz, s):
        total = None
        for h, (dx, dy, dz) in zip(_corner_hashes(jx, jy, jz, s),
                                   _CORNER_OFFSETS):
            cx, cy, cz = gx - dx, gy - dy, gz - dz
            a = torch.clamp(0.75 - cx * cx - cy * cy - cz * cz, min=0.0)
            a2 = a * a
            c = a2 * a2 * _grad_dot(h, cx, cy, cz)
            total = c if total is None else total + c
        return total

    n = lattice_sum(ix, iy, iz, fx, fy, fz, seed)
    bx = (fx < 0.5).to(torch.int32)
    by = (fy < 0.5).to(torch.int32)
    bz = (fz < 0.5).to(torch.int32)
    n = n + lattice_sum(
        ix - bx, iy - by, iz - bz,
        fx + bx.to(torch.float32) - 0.5,
        fy + by.to(torch.float32) - 0.5,
        fz + bz.to(torch.float32) - 0.5,
        seed + _LATTICE2_SALT)
    return n * _OS2S_NORM


def cellular_noise3(x, y, z, seed: int = 0, jitter: float = 1.0,
                    return_type: str = "distance"):
    """Cellular (Worley) noise over the 3×3×3 cell neighbourhood:
    ``distance`` (F1 mapped to ≈[-1, 1]), ``cell_value`` (the closest
    cell's hashed value) or ``distance2`` (F2 − F1).  The bake basis."""
    ix, fx = _floor_int(x)
    iy, fy = _floor_int(y)
    iz, fz = _floor_int(z)
    ix, iy, iz = (i.to(torch.int64) for i in (ix, iy, iz))

    f1 = torch.full_like(x, 1e10)
    f2 = torch.full_like(x, 1e10)
    closest_h = torch.zeros_like(ix)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                h = hash3(ix + dx, iy + dy, iz + dz, seed)
                ox = _hash_to_unit(h) * jitter
                oy = _hash_to_unit(_mix(h ^ 0xABCD1234)) * jitter
                oz = _hash_to_unit(_mix(h ^ 0x1B56C4E9)) * jitter
                ddx = dx + ox - fx
                ddy = dy + oy - fy
                ddz = dz + oz - fz
                d = ddx * ddx + ddy * ddy + ddz * ddz
                is_closer = d < f1
                f2 = torch.where(is_closer, f1, torch.minimum(f2, d))
                closest_h = torch.where(is_closer, h, closest_h)
                f1 = torch.where(is_closer, d, f1)

    if return_type == "cell_value":
        return _hash_to_signed(closest_h)
    if return_type == "distance2":
        return torch.sqrt(f2) - torch.sqrt(f1) - 1.0
    return torch.sqrt(f1) * 2.0 - 1.0


def cellular_noise3_fast(x, y, z, seed: int = 0, jitter: float = 1.0,
                         return_type: str = "distance"):
    """8-cell Worley F1, the in-march cellular approximation: the 2×2×2
    cells around the nearest lattice corner, with the feature points of
    :func:`cellular_noise3`.  ``distance`` only (F2 needs the 27 cells)."""
    ix, fx = _floor_int(x)
    iy, fy = _floor_int(y)
    iz, fz = _floor_int(z)
    bx = (fx >= 0.5).to(torch.int32) - 1
    by = (fy >= 0.5).to(torch.int32) - 1
    bz = (fz >= 0.5).to(torch.int32) - 1
    hx0 = _mul32(_u32(ix + bx), 0x9E3779B1)
    hy0 = _mul32(_u32(iy + by), 0x85EBCA77)
    hz0 = _add32(_mul32(_u32(iz + bz), 0xC2B2AE3D), seed & _MASK32)
    fbx = bx.to(torch.float32) - fx
    fby = by.to(torch.float32) - fy
    fbz = bz.to(torch.float32) - fz
    f1 = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                h = _mix((hx0 + (0x9E3779B1 if dx else 0) + hy0 + (0x85EBCA77 if dy else 0)
                          + hz0 + (0xC2B2AE3D if dz else 0)) & _MASK32)
                ox = _hash_to_unit(h) * jitter
                oy = _hash_to_unit(_mix(h ^ 0xABCD1234)) * jitter
                oz = _hash_to_unit(_mix(h ^ 0x1B56C4E9)) * jitter
                ddx = fbx + dx + ox
                ddy = fby + dy + oy
                ddz = fbz + dz + oz
                d = ddx * ddx + ddy * ddy + ddz * ddz
                f1 = d if f1 is None else torch.minimum(f1, d)
    if return_type != "distance":
        raise ValueError("cellular_fast supports return_type='distance' "
                         "only (use 'cellular' for cell_value/distance2)")
    return torch.sqrt(f1) * 2.0 - 1.0


_BASES = {
    "value": value_noise3,
    "perlin": perlin_noise3,
    "simplex": simplex_noise3,
    "simplex_smooth": simplex_smooth_noise3,
    "cellular": cellular_noise3,
    "cellular_fast": cellular_noise3_fast,
}


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Static noise config — the FastNoiseLite parameter surface, with the
    same fields and defaults as the JAX package's ``NoiseSpec``."""

    noise_type: str = "simplex_smooth"
    seed: int = 0
    frequency: float = 0.01
    fractal_type: str = "fbm"  # none|fbm|ridged|ping_pong
    octaves: int = 5
    lacunarity: float = 2.0
    gain: float = 0.5
    ping_pong_strength: float = 2.0
    weighted_strength: float = 0.0
    cellular_jitter: float = 1.0
    cellular_return: str = "distance"
    warp_enabled: bool = False
    warp_amplitude: float = 30.0
    warp_frequency: float = 0.05
    warp_octaves: int = 5
    warp_lacunarity: float = 6.0
    warp_gain: float = 0.5


def _eval_base(spec: NoiseSpec, x, y, z, seed_offset: int = 0):
    fn = _BASES[spec.noise_type]
    if spec.noise_type in ("cellular", "cellular_fast"):
        return fn(x, y, z, seed=spec.seed + seed_offset,
                  jitter=spec.cellular_jitter, return_type=spec.cellular_return)
    return fn(x, y, z, seed=spec.seed + seed_offset)


def fractal_bounding(spec: NoiseSpec) -> float:
    """FastNoiseLite's fractal bounding: ``1 / Σ gainᵒ`` (host double)."""
    amp_sum, a = 0.0, 1.0
    for _ in range(spec.octaves):
        amp_sum += a
        a *= spec.gain
    return 1.0 / amp_sum


def _fractal(spec: NoiseSpec, x, y, z):
    """FastNoiseLite's fractals; ``weighted_strength`` scales each next
    octave's amplitude by a weight of this octave's value (the amplitude
    is then a per-sample f32 plane)."""
    if spec.fractal_type == "none":
        return _eval_base(spec, x, y, z)
    if spec.fractal_type not in ("fbm", "ridged", "ping_pong"):
        raise ValueError(f"unknown fractal_type {spec.fractal_type}")
    total = torch.zeros_like(x)
    amp = fractal_bounding(spec)
    ws = spec.weighted_strength
    fx, fy, fz = x, y, z
    for o in range(spec.octaves):
        n = _eval_base(spec, fx, fy, fz, seed_offset=o)
        if spec.fractal_type == "fbm":
            total = total + n * amp
            if ws:
                amp = amp * (1.0 + (torch.clamp(n + 1.0, max=2.0) * 0.5 - 1.0) * ws)
        elif spec.fractal_type == "ridged":
            n = n.abs()
            total = total + (n * -2.0 + 1.0) * amp
            if ws:
                amp = amp * (1.0 + ((1.0 - n) - 1.0) * ws)
        else:
            t = (n + 1.0) * spec.ping_pong_strength
            t = t - torch.floor(t * 0.5) * 2.0
            t = torch.where(t < 1.0, t, 2.0 - t)
            total = total + (t - 0.5) * 2.0 * amp
            if ws:
                amp = amp * (1.0 + (t - 1.0) * ws)
        fx = fx * spec.lacunarity
        fy = fy * spec.lacunarity
        fz = fz * spec.lacunarity
        amp = amp * spec.gain
    return total


def _warp(spec: NoiseSpec, x, y, z):
    """Progressive fractal domain warp from one value-noise vec3 pass per
    octave."""
    amp = spec.warp_amplitude
    freq = spec.warp_frequency
    wx, wy, wz = x, y, z
    for o in range(spec.warp_octaves):
        sx, sy, sz = value_noise3_vec3(wx * freq, wy * freq, wz * freq,
                                       seed=spec.seed + 1000 + o)
        wx = wx + sx * amp
        wy = wy + sy * amp
        wz = wz + sz * amp
        amp *= spec.warp_gain
        freq *= spec.warp_lacunarity
    return wx, wy, wz


def sample_noise3(spec: NoiseSpec, x, y, z):
    """The full pipeline (warp → fractal → base) at world coordinates."""
    if spec.warp_enabled:
        x, y, z = _warp(spec, x, y, z)
    return _fractal(spec, x * spec.frequency, y * spec.frequency,
                    z * spec.frequency)
