"""The reference's pyramid samplers: the mip pyramids of a baked shape
texture and coverage map, and their batched samplers, which choose one mip
level and mode per batch of positions, as the megakernel's texture mode
(kernel K2 inside K1) samples them.

A copy of the plain half of the port's ``ops/kernels/texsample.py`` (its
host-side pyramid builders, the per-batch level choice and the batched knot
samplers), importing only the reference's own modules.  Left out: the
kernel route and the panorama sky's pyramids.

* :class:`TexMeta`, :func:`build_tex3d_pyramid` (64³ → 8³ box-filtered
  levels), :func:`build_latlong_pyramid` (cube faces resampled to a
  lat-long map, 512×256 → 32×16): every level stored flat (``lin = (z·S +
  y)·S + x`` or ``v·W + u``), levels concatenated into one ``(rows, 128)``
  f32 table with ``PAD_ROWS`` zero rows at the end.
* :func:`sample_tex3d_batched` / :func:`sample_latlong_batched` over knot
  planes cut into the kernel's batches (each call's per-batch choices can
  be recorded: :func:`record_batch_choices`), and :func:`pyramid_samplers`,
  the field closures over them.  The result depends on the batch: the
  wrapped coordinates' min and max over the whole batch choose one level
  and one mode for it — *windowed* (the finest level whose footprint does
  not wrap and whose flat span fits ``window_rows`` rows of 128), *banded*
  (a strictly finer level whose (y, x) span fits ``band_rows`` rows and
  whose z span is at most ``band_max_slices``; 3D only) or *floor* (nearest
  sample with wrap from the whole-level floor ``TexMeta.floor_level``).
  Windowed and banded batches are trilinear (bilinear) at the chosen level
  with no wrap by construction; the sums keep the kernel's order (corner
  terms in lookup order, a banded sample as the sum of its two z-slices'
  partial sums).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from .sampling import extend_cubemap_borders, sample_cubemap_seamless
from .vecmath import Vec3, normalize

LANES = 128
#: zero rows appended to every pyramid: a window anchored at the last level
#: never leaves the table
PAD_ROWS = 64
#: the batch modes, as :func:`record_batch_choices` records them
WINDOWED, BANDED, FLOOR = 0, 1, 2
# the calls of the batched knot samplers inside record_batch_choices
_recorded = None


@contextlib.contextmanager
def record_batch_choices():
    """Inside the block, each call of :func:`sample_tex3d_batched` and
    :func:`sample_latlong_batched` appends its batches' ``(mode, level)``
    (``(B,)`` int64 each, batches row-major) to the list it yields."""
    global _recorded
    saved, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = saved


# -- host-side pyramid packing ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TexMeta:
    """Static pyramid description: ``kind`` is ``"tex3d"`` or ``"latlong"``;
    ``levels`` per level, finest first, ``(S, base_row)`` for tex3d and
    ``(H, W, base_row)`` for latlong; ``rows`` of the whole table."""

    kind: str
    levels: Tuple[Tuple[int, ...], ...]
    rows: int

    def floor_level(self, window_rows: int) -> int:
        """Finest level whose whole data fits ``max(window_rows, 32)``
        rows: the wrap-safe nearest-sample fallback."""
        budget = max(window_rows, 32) * LANES
        for i, lv in enumerate(self.levels):
            n = lv[0] ** 3 if self.kind == "tex3d" else lv[0] * lv[1]
            if n <= budget:
                return i
        return len(self.levels) - 1


def _pack_flat(levels_flat) -> np.ndarray:
    total = sum(f.size for f in levels_flat)
    rows = (total + LANES - 1) // LANES + PAD_ROWS
    data = np.zeros(rows * LANES, np.float32)
    data[:total] = np.concatenate([f.ravel() for f in levels_flat])
    return data.reshape(rows, LANES)


def build_tex3d_pyramid(tex) -> Tuple[np.ndarray, TexMeta]:
    """``(S, S, S)`` f32, S a power of two in [8, 128] → flat mip pyramid
    (levels S, S/2, …, 8; wrap-preserving 2× box filter).  Raises
    ``ValueError`` for any other shape."""
    tex = np.asarray(tex, np.float32)
    if tex.ndim != 3 or len(set(tex.shape)) != 1:
        raise ValueError(f"shape texture must be cubic, got {tex.shape}")
    s = tex.shape[0]
    if s < 8 or s > 128 or (s & (s - 1)):
        raise ValueError(f"shape texture size must be a power of two in "
                         f"[8, 128], got {s}")
    levels, metas, base = [], [], 0
    cur = tex
    while True:
        levels.append(cur)
        metas.append((cur.shape[0], base))
        base += (cur.size + LANES - 1) // LANES
        if cur.shape[0] <= 8:
            break
        h = cur.shape[0] // 2
        cur = cur.reshape(h, 2, h, 2, h, 2).mean(axis=(1, 3, 5))
    flat = []
    for lv in levels:  # each level padded to a row boundary
        f = lv.ravel()
        flat.append(np.pad(f, (0, (-f.size) % LANES)))
    data = _pack_flat(flat)
    return data, TexMeta(kind="tex3d", levels=tuple(metas), rows=data.shape[0])


def latlong_dirs(height: int, width: int) -> Vec3:
    """Directions of lat-long texel centers (u: azimuth around y, v: north
    pole at v = 0), computed in float64 and rounded to f32 CPU tensors."""
    u = (np.arange(width) + 0.5) / width
    v = (np.arange(height) + 0.5) / height
    theta = (u - 0.5) * (2.0 * np.pi)  # atan2(z, x)
    phi = (0.5 - v) * np.pi  # asin(y)
    ct = np.cos(theta)[None, :]
    st = np.sin(theta)[None, :]
    cp = np.cos(phi)[:, None]
    sp = np.sin(phi)[:, None] * np.ones((1, width))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return Vec3(f32(cp * ct), f32(sp), f32(cp * st))


def build_latlong_pyramid(faces, width: int = 512) -> Tuple[np.ndarray, TexMeta]:
    """Cubemap ``(6, R, R)`` → lat-long mip pyramid ``(width, width/2)``
    down to 32×16, resampled through the seamless cubemap sampler.  Raises
    ``ValueError`` for a width outside the powers of two in [64, 2048]."""
    if width & (width - 1) or width < 64 or width > 2048:
        raise ValueError(f"latlong width must be a power of two in "
                         f"[64, 2048], got {width}")
    faces = np.asarray(faces, np.float32)
    if faces.ndim != 3 or faces.shape[0] != 6 or faces.shape[1] != faces.shape[2]:
        raise ValueError(f"coverage cubemap must be (6, R, R), got {faces.shape}")
    base_img = sample_cubemap_seamless(
        extend_cubemap_borders(torch.from_numpy(faces)),
        latlong_dirs(width // 2, width)).numpy()
    return _pack_latlong_mips(base_img)


def _pack_latlong_mips(base_img: np.ndarray):
    """(H, W) lat-long base level → flat 2×-box-filtered mip pyramid."""
    metas, base, flat = [], 0, []
    cur = base_img
    while True:
        metas.append((cur.shape[0], cur.shape[1], base))
        f = cur.ravel()
        pad = (-f.size) % LANES
        flat.append(np.pad(f, (0, pad)))
        base += (f.size + pad) // LANES
        if cur.shape[1] <= 32:
            break
        h, w = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur.reshape(h, 2, w, 2).mean(axis=(1, 3))
    data = _pack_flat(flat)
    return data, TexMeta(kind="latlong", levels=tuple(metas), rows=data.shape[0])


# -- polynomial inverse trig (the TPU kernel's; a 1e-5 rad change moves texels)
#
# Evaluated as the compiled JAX samplers evaluate it: XLA contracts every
# multiply-add of this chain into one fused multiply-add, so here each one
# is rounded once, through float64 (exact for f32 operands), and the CUDA
# kernel uses fmaf at the same places.


def _f32(c: float) -> float:
    return float(np.float32(c))


def _fma(a, b, c):
    """``a·b + c`` rounded once to f32."""
    return (a.double() * b + c).float()


def _atan_unit(t):
    """atan on [0, 1], minimax polynomial, max error ~1e-5 rad."""
    t2 = t * t
    p = _fma(t2, _f32(0.0208351), _f32(-0.0851330))
    p = _fma(t2, p, _f32(0.1801410))
    p = _fma(t2, p, _f32(-0.3302995))
    p = _fma(t2, p, _f32(0.9998660))
    return t * p


def atan2_poly(y, x):
    """Branch-free polynomial atan2, range (-π, π]."""
    ax, ay = x.abs(), y.abs()
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    a = _atan_unit(t)
    a = torch.where(ay > ax, (np.pi / 2) - a, a)
    a = torch.where(x < 0.0, np.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def asin_poly(y):
    """asin through ``atan2(y, √(1 − y²))``; y clipped to [-1, 1].  The
    square root is taken in float64 and rounded: a correctly rounded f32
    root, as XLA's and CUDA's are (PyTorch's vectorized CPU ``sqrt`` is not
    always, and one ulp here moves a lat-long texel weight)."""
    y = torch.clamp(y, -1.0, 1.0)
    root = torch.sqrt(torch.clamp(_fma(-y, y, 1.0), min=0.0).double()).float()
    return atan2_poly(y, root)


def latlong_uv(d: Vec3):
    """Unit direction → lat-long ``(u, v)``: u = atan2(z, x)/2π + 0.5,
    v = 0.5 − asin(y)/π."""
    u = _fma(atan2_poly(d.z, d.x), _f32(1.0 / (2.0 * np.pi)), 0.5)
    v = _fma(-asin_poly(d.y), _f32(1.0 / np.pi), 0.5)
    return u, v


# -- level and mode choice, per batch -----------------------------------------


def _choose(fits, fits_band, floor_idx):
    """Fold per-level fit flags (lists of (B,) bools, finest first) into
    per-batch ``(mode, level)``: the finest fitting level wins; banding
    only where it reaches a strictly finer level than the window."""
    sel = torch.full_like(fits[0], floor_idx, dtype=torch.int64)
    sel_b = sel.clone()
    windowed = torch.zeros_like(fits[0])
    banded = torch.zeros_like(fits[0])
    for i in range(len(fits) - 1, -1, -1):
        sel = torch.where(fits[i], i, sel)
        windowed = windowed | fits[i]
        sel_b = torch.where(fits_band[i], i, sel_b)
        banded = banded | fits_band[i]
    use_band = banded & (~windowed | (sel_b < sel))
    mode = torch.where(use_band, BANDED, torch.where(windowed, WINDOWED, FLOOR))
    level = torch.where(use_band, sel_b, torch.where(windowed, sel, floor_idx))
    return mode, level


def _tex3d_choice(meta: TexMeta, mins, maxs, window_rows: int, band_rows: int,
                  band_max_slices: int):
    """``mins``/``maxs``: per-axis (x, y, z) (B,) extremes of the wrapped
    coordinates.  The float comparisons of ``texsample.py:383-420``."""
    fits, fits_band = [], []
    for S, _ in meta.levels:
        ok = torch.ones_like(mins[0], dtype=torch.bool)
        span = torch.zeros_like(mins[0])
        spans_ax = []
        for ax, (mn, mx) in enumerate(zip(mins, maxs)):
            i_lo = torch.floor(mn * S - 0.5)
            i_hi = torch.floor(mx * S - 0.5) + 1.0
            ok = ok & (i_lo >= 0.0) & (i_hi <= S - 1.0)
            span = span + (i_hi - i_lo) * float(S ** ax)
            spans_ax.append(i_hi - i_lo)
        fits.append(ok & (span + (LANES - 1) <= window_rows * LANES - 1))
        if band_rows:
            yx_span = spans_ax[1] * float(S) + spans_ax[0]
            fits_band.append(ok & (yx_span + (LANES - 1) <= band_rows * LANES - 1)
                             & (spans_ax[2] + 1.0 <= band_max_slices))
        else:
            fits_band.append(torch.zeros_like(ok))
    return _choose(fits, fits_band, meta.floor_level(window_rows))


def _latlong_choice(meta: TexMeta, umin, umax, vmin, vmax, window_rows: int):
    """The lat-long fit checks of ``texsample.py:556-569``."""
    fits = []
    for Hl, Wl, _ in meta.levels:
        iu_lo = torch.floor(umin * Wl - 0.5)
        iu_hi = torch.floor(umax * Wl - 0.5) + 1.0
        iv_lo = torch.clamp(torch.floor(vmin * Hl - 0.5), min=0.0)
        iv_hi = torch.clamp(torch.floor(vmax * Hl - 0.5) + 1.0, max=Hl - 1.0)
        ok = (iu_lo >= 0.0) & (iu_hi <= Wl - 1.0)
        span = (iv_hi - iv_lo) * float(Wl) + (iu_hi - iu_lo)
        fits.append(ok & (span + (LANES - 1) <= window_rows * LANES - 1))
    return _choose(fits, [torch.zeros_like(f) for f in fits],
                   meta.floor_level(window_rows))


def _level_table(meta: TexMeta, level: torch.Tensor, col: int):
    """Per-batch value of column ``col`` of ``meta.levels`` at ``level``."""
    values = torch.tensor([lv[col] for lv in meta.levels], device=level.device)
    return values[level]


# -- lookups -------------------------------------------------------------------


def _gather(flat, base_row, lin):
    """Direct gather ``flat[base_row·128 + lin]``; indices of lanes whose
    batch takes another mode are clamped into the table and discarded."""
    idx = base_row * LANES + lin
    return flat[idx.clamp(0, flat.numel() - 1)]


def _trilinear(flat, S, base_row, fx, fy, fz):
    """Trilinear at one level per batch (``S``, ``base_row``: (B, 1)), no
    wrap.  Returns ``(first four corner terms, all eight)`` summed in
    lookup order: a banded sample is the sum of the two z-slices."""
    Sf = S.to(torch.float32)

    def prep(f):
        t = f * Sf - 0.5
        i0 = torch.floor(t)
        return i0.to(torch.int64), t - i0

    x0, wx = prep(fx)
    y0, wy = prep(fy)
    z0, wz = prep(fz)
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    lin00 = (z0 * S + y0) * S
    lin01 = (z0 * S + y1) * S
    lin10 = (z1 * S + y0) * S
    lin11 = (z1 * S + y1) * S
    corners = [
        (lin00 + x0, (1 - wz) * (1 - wy) * (1 - wx)),
        (lin00 + x1, (1 - wz) * (1 - wy) * wx),
        (lin01 + x0, (1 - wz) * wy * (1 - wx)),
        (lin01 + x1, (1 - wz) * wy * wx),
        (lin10 + x0, wz * (1 - wy) * (1 - wx)),
        (lin10 + x1, wz * (1 - wy) * wx),
        (lin11 + x0, wz * wy * (1 - wx)),
        (lin11 + x1, wz * wy * wx),
    ]
    terms = [_gather(flat, base_row, lin) * w for lin, w in corners]
    lo = terms[0] + terms[1] + terms[2] + terms[3]
    hi = terms[4] + terms[5] + terms[6] + terms[7]
    full = lo + terms[4] + terms[5] + terms[6] + terms[7]
    return full, lo + hi


def _tex3d_batches(flat, meta: TexMeta, x, y, z, window_rows, band_rows,
                   band_max_slices):
    """K2's 3D sampler over ``(B, N)`` coordinates, one batch per row.
    Returns ``(values, mode, level)``."""
    fx, fy, fz = (c - torch.floor(c) for c in (x, y, z))
    mins = [f.amin(dim=1) for f in (fx, fy, fz)]
    maxs = [f.amax(dim=1) for f in (fx, fy, fz)]
    mode, level = _tex3d_choice(meta, mins, maxs, window_rows, band_rows,
                                band_max_slices)
    S = _level_table(meta, level, 0)[:, None]
    base = _level_table(meta, level, 1)[:, None]
    windowed, banded = _trilinear(flat, S, base, fx, fy, fz)

    S_f, base_f = meta.levels[meta.floor_level(window_rows)]

    def near(f):
        return torch.floor(f * S_f).to(torch.int64) & (S_f - 1)

    floor = _gather(flat, base_f, (near(fz) * S_f + near(fy)) * S_f + near(fx))
    m = mode[:, None]
    out = torch.where(m == WINDOWED, windowed, torch.where(m == BANDED, banded, floor))
    return out, mode, level


def _latlong_coords(meta: TexMeta, d: Vec3, window_rows):
    """Wrapped ``(fu, v)`` of ``(B, N)`` unit directions and each batch's
    ``(mode, level)``."""
    u, v = latlong_uv(d)
    fu = u - torch.floor(u)
    mode, level = _latlong_choice(meta, fu.amin(dim=1), fu.amax(dim=1),
                                  v.amin(dim=1), v.amax(dim=1), window_rows)
    return fu, v, mode, level


def _latlong_batches(flat, meta: TexMeta, d: Vec3, window_rows):
    """K2's lat-long sampler over ``(B, N)`` unit directions."""
    fu, v, mode, level = _latlong_coords(meta, d, window_rows)
    return _latlong_lookup(flat, meta, fu, v, mode, level, window_rows), mode, level


def _latlong_lookup(flat, meta: TexMeta, fu, v, mode, level, window_rows):
    """The samples of one pyramid at each batch's choice: bilinear at its
    level, or nearest from the floor level."""
    Hs = _level_table(meta, level, 0)[:, None]
    Ws = _level_table(meta, level, 1)[:, None]
    base = _level_table(meta, level, 2)[:, None]
    Hf, Wf = Hs.to(torch.float32), Ws.to(torch.float32)
    tu = fu * Wf - 0.5
    u0f = torch.floor(tu)
    wu = tu - u0f
    u0 = u0f.to(torch.int64)
    u1 = u0 + 1
    tv = v * Hf - 0.5
    v0f = torch.minimum(torch.clamp(torch.floor(tv), min=0.0), Hf - 1.0)
    wv = torch.clamp(tv - v0f, 0.0, 1.0)
    v0 = v0f.to(torch.int64)
    v1 = torch.minimum(v0 + 1, Hs - 1)
    lin0, lin1 = v0 * Ws, v1 * Ws
    windowed = (_gather(flat, base, lin0 + u0) * ((1 - wv) * (1 - wu))
                + _gather(flat, base, lin0 + u1) * ((1 - wv) * wu)
                + _gather(flat, base, lin1 + u0) * (wv * (1 - wu))
                + _gather(flat, base, lin1 + u1) * (wv * wu))

    H_f, W_f, base_f = meta.levels[meta.floor_level(window_rows)]
    un = torch.floor(fu * W_f).to(torch.int64) & (W_f - 1)
    vn = torch.clamp(torch.floor(v * H_f).to(torch.int64), 0, H_f - 1)
    floor = _gather(flat, base_f, vn * W_f + un)
    return torch.where(mode[:, None] == WINDOWED, windowed, floor)


# -- entry points -----------------------------------------------------------------


def _flat(table: torch.Tensor) -> torch.Tensor:
    if table.dim() != 2 or table.shape[1] != LANES or table.dtype != torch.float32:
        raise ValueError(f"pyramid table must be (rows, {LANES}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return table.reshape(-1)


def _to_batches(a: torch.Tensor, batch_rows: int) -> torch.Tensor:
    """``(G, R, W)`` planes → ``(B, G·batch_rows·128)``: batch ``(i, j)``
    holds rows ``[i·batch_rows, (i+1)·batch_rows)`` and columns
    ``[j·128, (j+1)·128)`` of every plane."""
    g, r, w = a.shape
    if r % batch_rows or w % LANES:
        raise ValueError(f"knot planes {tuple(a.shape)} do not split into "
                         f"{batch_rows}×{LANES} batches")
    nb_r, nb_c = r // batch_rows, w // LANES
    a = a.reshape(g, nb_r, batch_rows, nb_c, LANES).permute(1, 3, 0, 2, 4)
    return a.reshape(nb_r * nb_c, -1)


def _from_batches(b: torch.Tensor, shape, batch_rows: int) -> torch.Tensor:
    g, r, w = shape
    nb_r, nb_c = r // batch_rows, w // LANES
    b = b.reshape(nb_r, nb_c, g, batch_rows, LANES).permute(2, 0, 3, 1, 4)
    return b.reshape(g, r, w)


def _planes(c: torch.Tensor) -> torch.Tensor:
    return c if c.dim() == 3 else c[None]


def sample_tex3d_batched(table, meta: TexMeta, x, y, z, batch_rows: int,
                         window_rows: int = 16, band_rows: int = 16,
                         band_max_slices: int = 32) -> torch.Tensor:
    """Plain K2 3D sampler over knot planes ``(G, rows, W)`` (or one plane
    ``(rows, W)``): each ``batch_rows × 128`` block of all G planes is one
    batch, as one megakernel tile's knot group is."""
    shape = x.shape
    x, y, z = (_planes(c) for c in (x, y, z))
    out, mode, level = _tex3d_batches(_flat(table), meta,
                                      *(_to_batches(c, batch_rows) for c in (x, y, z)),
                                      window_rows, band_rows, band_max_slices)
    if _recorded is not None:
        _recorded.append((mode, level))
    return _from_batches(out, x.shape, batch_rows).reshape(shape)


def sample_latlong_batched(table, meta: TexMeta, d: Vec3, batch_rows: int,
                           window_rows: int = 16) -> torch.Tensor:
    """Plain K2 lat-long sampler over direction planes cut into batches as
    :func:`sample_tex3d_batched` cuts them."""
    shape = d.x.shape
    planes = [_planes(c) for c in d]
    out, mode, level = _latlong_batches(
        _flat(table), meta, Vec3(*(_to_batches(c, batch_rows) for c in planes)),
        window_rows)
    if _recorded is not None:
        _recorded.append((mode, level))
    return _from_batches(out, planes[0].shape, batch_rows).reshape(shape)


def pyramid_samplers(config, shape_table, coverage_table, batch_rows: int):
    """The megakernel's field closures over the pyramids (the in-kernel
    samplers of ``megakernel.py:187-211``): shape at texture coordinates,
    coverage at (unnormalized) coverage-space positions.  Only a field with
    a meta gets one; the other is ``None`` (its procedural closure
    stays)."""
    meta_s, meta_c = config.cloud_shape_tex_meta, config.cloud_coverage_tex_meta
    w_rows = config.texture_window_rows

    def shape_fn(p: Vec3):
        return sample_tex3d_batched(shape_table, meta_s, p.x, p.y, p.z, batch_rows,
                                    window_rows=w_rows,
                                    band_rows=config.texture_band_rows,
                                    band_max_slices=config.texture_band_max_slices)

    def coverage_fn(p: Vec3):
        return sample_latlong_batched(coverage_table, meta_c, normalize(p), batch_rows,
                                      window_rows=w_rows)

    return (shape_fn if meta_s is not None else None,
            coverage_fn if meta_c is not None else None)
