"""Texture sampling and bakes: trilinear 3D with repeat, cubemap bilinear
(per-face clamp, or seamless through a border-extended stack), equirect
bilinear (the panorama sky), and the noise bakes that make the demo's
shape texture and coverage cubemap.

Counterpart of ``godot_atmosphere_shader_tpu/ops/sampling.py``, same
formulas in the same operation order.  These are the exact samplers of the
plain texture path (the JAX package's ``renderer="xla"``); the megakernel
samples mip pyramids instead (``ops/kernels/texsample.py``).  Cube faces are
ordered +X, -X, +Y, -Y, +Z, -Z with the reference generator's basis
swizzles (``noise_cubemap.gd:110-128``).
"""

from __future__ import annotations

import math

import torch

from .vecmath import Vec3, normalize
from .noise import NoiseSpec, sample_noise3


def sample_trilinear_repeat(tex: torch.Tensor, x, y, z) -> torch.Tensor:
    """GL ``texture()`` on a repeat-wrapped ``sampler3D``: ``tex`` is
    ``[D(z), H(y), W(x)]``, coordinates in periods, texel centers at
    ``(i + 0.5) / N``."""
    d, h, w = tex.shape

    def prep(c, n):
        t = c * n - 0.5
        i0 = torch.floor(t)
        f = t - i0
        i0 = torch.remainder(i0.to(torch.int64), n)
        i1 = torch.remainder(i0 + 1, n)
        return i0, i1, f

    x0, x1, fx = prep(x, w)
    y0, y1, fy = prep(y, h)
    z0, z1, fz = prep(z, d)
    flat = tex.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c000, c100 = at(z0, y0, x0), at(z0, y0, x1)
    c010, c110 = at(z0, y1, x0), at(z0, y1, x1)
    c001, c101 = at(z1, y0, x0), at(z1, y0, x1)
    c011, c111 = at(z1, y1, x0), at(z1, y1, x1)
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0v = x00 + (x10 - x00) * fy
    y1v = x01 + (x11 - x01) * fy
    return y0v + (y1v - y0v) * fz


def cubemap_face_uv(direction: Vec3):
    """Direction → ``(face, u, v)``, ``u, v ∈ [-1, 1]`` on the major-axis
    face; the inverse of the generator mapping."""
    x, y, z = direction.x, direction.y, direction.z
    ax, ay, az = x.abs(), y.abs(), z.abs()
    x_major = (ax >= ay) & (ax >= az)
    y_major = ~x_major & (ay >= az)
    face = torch.where(x_major, torch.where(x >= 0, 0, 1),
                       torch.where(y_major, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    s = torch.where(x_major, ax, torch.where(y_major, ay, az))
    inv = 1.0 / torch.clamp(s, min=1e-20)
    u = torch.where(face == 0, -z, torch.where(face == 1, z, torch.where(
        face <= 4, x, -x))) * inv
    v = torch.where(face == 2, -z, torch.where(face == 3, z, y)) * inv
    return face, u, v


def _bilinear_faces(faces: torch.Tensor, face, px, py) -> torch.Tensor:
    """Clamped bilinear lookup at texel coordinates ``(px, py)`` of each
    sample's face in a ``(6, n, n)`` stack."""
    _, n, _ = faces.shape
    px = torch.clamp(px, 0.0, n - 1.0)
    py = torch.clamp(py, 0.0, n - 1.0)
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=n - 1)
    y1 = torch.clamp(y0 + 1, max=n - 1)
    fx = px - x0.to(torch.float32)
    fy = py - y0.to(torch.float32)
    flat = faces.reshape(-1)
    base = face.to(torch.int64) * (n * n)

    def at(yi, xi):
        return flat[base + yi * n + xi]

    top = at(y0, x0) * (1.0 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1.0 - fx) + at(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def sample_cubemap_bilinear(faces: torch.Tensor, direction: Vec3) -> torch.Tensor:
    """``texture(samplerCube, dir)`` with per-face clamp-to-edge bilinear
    on ``(6, res, res)`` faces."""
    _, res, _ = faces.shape
    face, u, v = cubemap_face_uv(direction)
    half = res * 0.5
    px = (u + 1.0) * half - 0.5
    py = res - 0.5 - (v + 1.0) * half
    return _bilinear_faces(faces, face, px, py)


def _face_dirs_from_uv(uu: torch.Tensor, vv: torch.Tensor) -> Vec3:
    """Face-plane ``(u, v)`` grids → unit directions on all 6 faces,
    stacked ``(6, …)`` (the generator's swizzle table)."""
    inv_len = 1.0 / torch.sqrt(1.0 + uu * uu + vv * vv)
    bx = inv_len
    by = vv * inv_len
    bz = -uu * inv_len
    dirs = [(bx, by, bz), (-bx, by, -bz), (-bz, bx, -by),
            (-bz, -bx, by), (-bz, by, bx), (bz, by, -bx)]
    return Vec3(*(torch.stack([d[i] for d in dirs]) for i in range(3)))


def _face_grid(coords: torch.Tensor, res: int):
    """``(u, v)`` planes of the texel grid at integer ``coords``."""
    half = 0.5 * res
    u = (coords + 0.5) / half - 1.0
    v = (res - coords - 1.0 + 0.5) / half - 1.0
    n = coords.shape[0]
    return u[None, :].expand(n, n), v[:, None].expand(n, n)


def cubemap_face_dirs(resolution: int, *, device) -> Vec3:
    """Unit directions of every texel center, ``(6, res, res)`` each."""
    coords = torch.arange(resolution, dtype=torch.float32, device=device)
    return _face_dirs_from_uv(*_face_grid(coords, resolution))


def extend_cubemap_borders(faces: torch.Tensor) -> torch.Tensor:
    """``(6, res, res)`` → ``(6, res + 2, res + 2)``: a one-texel border
    resampled from the adjacent faces (the bake-time half of seamless cube
    filtering); the interior is copied exactly."""
    _, res, _ = faces.shape
    coords = torch.arange(-1, res + 1, dtype=torch.float32, device=faces.device)
    ext = sample_cubemap_bilinear(faces, _face_dirs_from_uv(*_face_grid(coords, res)))
    ext[:, 1:-1, 1:-1] = faces
    return ext


def sample_cubemap_seamless(faces_ext: torch.Tensor, direction: Vec3) -> torch.Tensor:
    """``texture(samplerCube, dir)`` with cross-face seam blending, on the
    border-extended stack of :func:`extend_cubemap_borders`."""
    _, eres, _ = faces_ext.shape
    res = eres - 2
    face, u, v = cubemap_face_uv(direction)
    half = res * 0.5
    px = (u + 1.0) * half - 0.5 + 1.0  # +1: the border ring
    py = res - 0.5 - (v + 1.0) * half + 1.0
    return _bilinear_faces(faces_ext, face, px, py)


def sample_equirect_bilinear(tex: torch.Tensor, direction: Vec3) -> Vec3:
    """Equirect (lat-long) panorama sample, the ``PanoramaSkyMaterial``
    analog: ``tex`` is ``(H, W, 3)`` linear RGB; the direction is
    normalized, u = atan2(z, x)/2π + 0.5 wraps, v = 0.5 − asin(y)/π clamps
    at the poles, texel centers at ``(i + 0.5)/N``.  Exact trigonometry (the
    megakernel's pyramid sampler uses the polynomial one)."""
    h, w, _ = tex.shape
    d = normalize(direction)
    u = torch.atan2(d.z, d.x) * (1.0 / (2.0 * math.pi)) + 0.5
    v = 0.5 - torch.asin(torch.clamp(d.y, -1.0, 1.0)) * (1.0 / math.pi)
    pu = u * w - 0.5
    pv = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0f = torch.floor(pu)
    y0 = torch.floor(pv).to(torch.int64)
    fx = pu - x0f
    fy = pv - y0.to(torch.float32)
    x0 = torch.remainder(x0f.to(torch.int64), w)
    x1 = torch.remainder(x0 + 1, w)  # the azimuth seam wraps
    y1 = torch.clamp(y0 + 1, max=h - 1)  # the poles clamp
    flat = tex.reshape(-1, 3)
    out = []
    for c in range(3):
        ch = flat[:, c]
        top = ch[y0 * w + x0] * (1.0 - fx) + ch[y0 * w + x1] * fx
        bot = ch[y1 * w + x0] * (1.0 - fx) + ch[y1 * w + x1] * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return Vec3(*out)


# -- bakes --------------------------------------------------------------------


def bake_noise_cubemap(spec: NoiseSpec, scale, resolution: int, *,
                       device) -> torch.Tensor:
    """The NoiseCubemap bake ``0.5 + 0.5·noise(dir·scale)`` over all six
    faces, ``(6, res, res)`` f32 on ``device``."""
    d = cubemap_face_dirs(resolution, device=device)
    sx, sy, sz = scale
    return 0.5 + 0.5 * sample_noise3(spec, d.x * sx, d.y * sy, d.z * sz)


def bake_noise_texture3d(spec: NoiseSpec, resolution: int = 64, *,
                         device) -> torch.Tensor:
    """``NoiseTexture3D`` analog ``(res, res, res)`` in [0, 1]: noise over
    the voxel grid, each axis crossfaded near its end against a
    period-shifted copy so the texture tiles (the JAX bake's seamless
    mode, the only one any caller uses).  The eight shifted fields are
    evaluated in one batched noise call (elementwise, so bit-identical to
    eight calls)."""
    idx = torch.arange(resolution, dtype=torch.float32, device=device)
    shape = (resolution,) * 3
    zz = idx[:, None, None].expand(shape)
    yy = idx[None, :, None].expand(shape)
    xx = idx[None, None, :].expand(shape)
    p = float(resolution)
    # fields at (x - sx·p, y - sy·p, z - sz·p), shift bits (sx, sy, sz) in
    # the order the crossfade below consumes them
    shifts = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
    px, py, pz = (torch.stack([(c - p) if s[a] else c for s in shifts])
                  for a, c in enumerate((xx, yy, zz)))
    f = sample_noise3(spec, px, py, pz)

    def fade(c):
        return torch.clamp((c / p - 0.75) / (1.0 - 0.75), 0.0, 1.0)

    wx, wy, wz = fade(xx), fade(yy), fade(zz)
    n = f[0] * (1 - wx) + f[1] * wx
    n2 = f[2] * (1 - wx) + f[3] * wx
    n = n * (1 - wy) + n2 * wy
    n3a = f[4] * (1 - wx) + f[5] * wx
    n3b = f[6] * (1 - wx) + f[7] * wx
    n3 = n3a * (1 - wy) + n3b * wy
    n = n * (1 - wz) + n3 * wz
    return 0.5 + 0.5 * n
