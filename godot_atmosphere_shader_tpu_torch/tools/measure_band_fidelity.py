"""The banded sampler's fidelity on the demo frame (PARITY #12), the twin of
the JAX package's ``tools/measure_band_fidelity.py``.

The demo scene's baked 64³ shape field at the 1080p tile geometry: one K2
batch per 32×128 tile and group of shape knots (16 knots, groups of 8, 8
and 1; the last tile row has 24 rows), 1530 batches.

1. ``--fits``: which pyramid level each batch takes, windowed alone
   against windowed and banded, from the port's choice
   (``texsample._tex3d_choice``) over the wrapped extremes of the batch's
   hit pixels.  On a CUDA device K2 (``megakernel.sample_batches``) makes
   the choice too, and must make the same one in every batch whose pixels
   all hit.
2. ``--field-err``: on batches whose pixels all hit and where banding
   engages, the shape field sampled by K2 with ``band_rows`` 0 and 16
   against exact trilinear (``sampling.sample_trilinear_repeat``): mean,
   p99 and max of |Δ| over the first ``--max-batches`` such batches (0:
   every one).  On a CUDA device K2's values are also held against the
   plain samplers on the same batches.

Runs on the card unless ``--device cpu`` is given (there K2 is the plain
samplers)::

    python -m godot_atmosphere_shader_tpu_torch.tools.measure_band_fidelity \\
        [--pose interior] [--fits] [--field-err] [--max-batches N] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.demo import build_demo_scene, demo_camera
from ..ops.clouds import clamp_march_distance, cloud_settings
from ..ops.kernels import megakernel as mk
from ..ops.kernels import texsample as ts
from ..ops.sampling import sample_trilinear_repeat
from ..utils.camera import transform_dir, transform_point, world_ray_dirs
from ..utils.vecmath import Vec3, ray_sphere

LANES = ts.LANES
H, W = 1080, 1920
BLK = (32, 128)
WINDOW_ROWS = 16
BAND_ROWS = 16
BAND_MAX_SLICES = 32
KNOT_GROUP = 8
SHAPE_KNOTS = 16
#: the knot groups of a tile, ``(first, end)``: 8, 8 and 1 knots
GROUPS = tuple((g0, min(g0 + KNOT_GROUP, SHAPE_KNOTS + 1))
               for g0 in range(0, SHAPE_KNOTS + 1, KNOT_GROUP))


class Geometry(NamedTuple):
    """The demo frame's cloud-shell rays, in the shape field's model space."""

    t0: torch.Tensor  # (H, W) march start
    t1: torch.Tensor  # (H, W) march end
    ro: Vec3  # model-space ray origins, (H, W) planes
    rd: Vec3  # model-space ray directions
    hit: torch.Tensor  # (H, W) bool: the ray meets the cloud shell's top
    scale: float  # cloud_shape_scale: model space to shape-field periods
    tex: torch.Tensor  # (S, S, S) baked shape field


def batch_geometry(pose: str = "interior", device="cuda", textures=None) -> Geometry:
    """The twin of ``_batch_geometry`` (``tools/measure_band_fidelity.py:48``)
    on ``device``: the texture-mode demo scene (``textures`` = ``(shape,
    cubemap)`` if given, else baked on ``device``), the camera's rays
    against the cloud shell's top, and the march span clamped as the
    clouds clamp it."""
    device = torch.device(device)
    cam = demo_camera(pose, device=device)
    scene = build_demo_scene("clouds", procedural=False, device=device, textures=textures)
    scene.update(0.0, cam)
    _, params, _ = scene._sorted_layers(cam)
    p = params[0]

    rd = world_ray_dirs(cam, H, W)
    ro = Vec3(*(torch.full((H, W), float(v), device=device) for v in cam.position))
    settings = cloud_settings(p)
    m2w = np.linalg.inv(p.world_to_model.cpu().numpy())
    pc = Vec3(*(torch.full((H, W), float(v), device=device) for v in m2w[:3, 3]))
    top0, top1 = ray_sphere(pc, float(settings.top_height), ro, rd)
    t0 = torch.clamp(top0, min=0.0)
    ro_m = transform_point(p.world_to_model, ro)
    rd_m = transform_dir(p.world_to_model, rd)
    t1 = clamp_march_distance(ro_m, t0, top1, settings)
    return Geometry(t0, t1, ro_m, rd_m, top0 != top1, float(p.cloud_shape_scale),
                    p.cloud_shape_texture)


class Batches(NamedTuple):
    """Equal-length batches of one tile row and knot group: ``index`` (B,)
    each batch's place in the JAX tool's order (tile row, tile column,
    group); ``hit``, ``x``, ``y``, ``z`` (B, knots · rows · 128), knot-major
    as the JAX tool concatenates a batch's planes."""

    index: torch.Tensor
    hit: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _tiles(plane: torch.Tensor, rows: int) -> torch.Tensor:
    """``(rows, W)`` → ``(W / 128, rows · 128)``: one row per tile."""
    return plane.reshape(rows, -1, LANES).permute(1, 0, 2).reshape(-1, rows * LANES)


def iter_batches(geom: Geometry, require_full: bool = False):
    """The twin of ``_iter_batches`` (``tools/measure_band_fidelity.py:114``):
    one batch per tile and knot group, knot k's plane at ``t0 + (t1 - t0) ·
    k / 16`` in shape-field periods; batches without a hit pixel (with
    ``require_full``: with a pixel that misses) are left out.  Yields
    :class:`Batches` per tile row and group, in the JAX tool's order."""
    cols = W // BLK[1]
    for ty, gy in enumerate(range(0, H, BLK[0])):
        rows = min(BLK[0], H - gy)
        sl = slice(gy, gy + rows)
        t0, span = geom.t0[sl], geom.t1[sl] - geom.t0[sl]
        hit = _tiles(geom.hit[sl], rows)
        keep = hit.all(1) if require_full else hit.any(1)
        if not bool(keep.any()):
            continue
        for gi, (k0, k1) in enumerate(GROUPS):
            planes = [[], [], []]
            for k in range(k0, k1):
                tt = t0 + span * (k / SHAPE_KNOTS)
                for a in range(3):
                    planes[a].append(_tiles((geom.ro[a][sl] + geom.rd[a][sl] * tt) * geom.scale,
                                            rows))
            index = (ty * cols + torch.arange(cols, device=hit.device)) * len(GROUPS) + gi
            yield Batches(index[keep], hit.repeat(1, k1 - k0)[keep],
                          *(torch.cat(p, 1)[keep] for p in planes))


def tile_row(b: Batches) -> int:
    """The tile row of a :class:`Batches`."""
    return int(b.index[0]) // (W // BLK[1] * len(GROUPS))


def _pyramid(geom: Geometry):
    data, meta = ts.build_tex3d_pyramid(geom.tex.detach().cpu().numpy())
    return torch.as_tensor(data, device=geom.tex.device), meta


def batch_choice(meta, b: Batches, band_rows: int):
    """Each batch's ``(mode, level)`` from the wrapped extremes of its hit
    pixels (``texsample._tex3d_choice``)."""
    fr = [c - torch.floor(c) for c in (b.x, b.y, b.z)]
    inf = torch.tensor(float("inf"), device=b.x.device)
    mins = [torch.where(b.hit, f, inf).amin(1) for f in fr]
    maxs = [torch.where(b.hit, f, -inf).amax(1) for f in fr]
    return ts._tex3d_choice(meta, mins, maxs, WINDOW_ROWS, band_rows, BAND_MAX_SLICES)


def label_index(meta, mode: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The JAX tool's count slot of each ``(mode, level)``: the level, or
    ``len(meta.levels)`` (``floor``) for the floor mode."""
    return torch.where(mode == ts.FLOOR, len(meta.levels), level)


def run_fits(geom: Geometry) -> dict:
    """The level each batch takes, windowed alone (``band_rows`` 0) and
    windowed+banded (16), counted per level as the JAX tool prints them;
    on a CUDA device also K2's own choice over the same batches, compared
    in every batch whose pixels all hit.  Returns the counts, the batches'
    ``choices`` ((mode, level) of each, windowed and banded, in the JAX
    order) and K2's agreement."""
    table, meta = _pyramid(geom)
    k2 = table.is_cuda
    n = len(meta.levels)
    win_c = torch.zeros(n + 1, dtype=torch.int64)
    eff_c = torch.zeros(n + 1, dtype=torch.int64)
    index, choices, full, same = [], [], 0, 0
    for b in iter_batches(geom):
        win = batch_choice(meta, b, 0)
        eff = batch_choice(meta, b, BAND_ROWS)
        win_c += torch.bincount(label_index(meta, *win).cpu(), minlength=n + 1)
        eff_c += torch.bincount(label_index(meta, *eff).cpu(), minlength=n + 1)
        index.append(b.index)
        choices.append(torch.stack(win + eff, 1))
        if k2:
            _, mode, level = mk.sample_batches(table, meta, b.x, b.y, b.z, WINDOW_ROWS,
                                               BAND_ROWS, BAND_MAX_SLICES)
            all_hit = b.hit.all(1)
            full += int(all_hit.sum())
            same += int(((mode == eff[0]) & (level == eff[1]) & all_hit).sum())
    labels = [f"L{i}({lv[0]}^3)" for i, lv in enumerate(meta.levels)] + ["floor"]
    index = torch.cat(index)
    order = torch.argsort(index)
    out = {"batches": int(index.numel()),
           "windowed": {lb: int(c) for lb, c in zip(labels, win_c) if c},
           "banded": {lb: int(c) for lb, c in zip(labels, eff_c) if c},
           "index": index[order].cpu(), "choices": torch.cat(choices)[order].cpu()}
    if k2:
        out.update(k2_full_batches=full, k2_same_choice=same)
    return out


def _stats(err: np.ndarray) -> dict:
    return {"mean": float(err.mean()), "p99": float(np.percentile(err, 99)),
            "max": float(err.max())}


def run_field_err(geom: Geometry, max_batches: Optional[int] = 16) -> dict:
    """K2 with ``band_rows`` 0 and 16 against exact trilinear on the first
    ``max_batches`` batches (all of them with ``None``) whose pixels all hit
    and where banding changes a value, in the JAX tool's order.  On a CUDA
    device K2's values and choices are also held against the plain
    samplers on every such batch (``k2_vs_plain_max``,
    ``k2_vs_plain_same_choice``)."""
    table, meta = _pyramid(geom)
    on_card = table.is_cuda
    kept, k2_err, k2_same, tried, row = [], 0.0, True, 0, None
    for b in iter_batches(geom, require_full=True):
        if row != tile_row(b) and max_batches is not None and (
                sum(int(k[0].numel()) for k in kept) >= max_batches):
            break  # later tile rows come later in the JAX order
        row = tile_row(b)
        off = mk.sample_batches(table, meta, b.x, b.y, b.z, WINDOW_ROWS, 0, BAND_MAX_SLICES)
        on = mk.sample_batches(table, meta, b.x, b.y, b.z, WINDOW_ROWS, BAND_ROWS,
                               BAND_MAX_SLICES)
        tried += int(b.index.numel())
        engaged = (on[0] != off[0]).any(1)
        if on_card:
            for got, rows in ((off, 0), (on, BAND_ROWS)):
                ref = ts._tex3d_batches(table.reshape(-1), meta, b.x, b.y, b.z, WINDOW_ROWS,
                                        rows, BAND_MAX_SLICES)
                k2_err = max(k2_err, float((got[0] - ref[0]).abs().max()))
                k2_same = k2_same and bool(torch.equal(got[1], ref[1])
                                           and torch.equal(got[2], ref[2]))
        if bool(engaged.any()):
            kept.append((b.index[engaged], off[0][engaged], on[0][engaged],
                         *(c[engaged] for c in (b.x, b.y, b.z))))
    out = {"full_batches_tried": tried, "engaged_batches": 0}
    if on_card:
        out.update(k2_vs_plain_max=k2_err, k2_vs_plain_same_choice=k2_same)
    if not kept:
        return out
    first = torch.sort(torch.cat([k[0] for k in kept])).values[:max_batches]
    last = int(first[-1])
    errs = {"windowed": [], "banded": []}
    for index, off, on, x, y, z in kept:  # batches of one length each
        sel = index <= last
        exact = sample_trilinear_repeat(geom.tex, x[sel], y[sel], z[sel])
        errs["windowed"].append((off[sel] - exact).abs().cpu().numpy().ravel())
        errs["banded"].append((on[sel] - exact).abs().cpu().numpy().ravel())
    errs = {k: np.concatenate(v) for k, v in errs.items()}
    out.update(engaged_batches=int(first.numel()), samples=int(errs["windowed"].size),
               first_index=first.cpu().tolist()[:4],
               **{k: _stats(v) for k, v in errs.items()})
    return out


def _print_fits(pose: str, fits: dict):
    print(f"{pose}: {fits['batches']} batches")
    print("  windowed:", fits["windowed"])
    print("  +banded :", fits["banded"])
    if "k2_full_batches" in fits:
        print(f"  K2 on the card: the plain choice in {fits['k2_same_choice']} of "
              f"{fits['k2_full_batches']} batches whose pixels all hit")


def _print_field_err(pose: str, res: dict):
    if not res["engaged_batches"]:
        print(f"{pose}: banding never engaged in the sampled batches")
        return
    print(f"{pose}: {res['engaged_batches']} engaged batches, {res['samples']} samples")
    for name, label in (("windowed", "windowed-only"), ("banded", "banded       ")):
        s = res[name]
        print(f"  {label} vs exact: mean {s['mean']:.4f} p99 {s['p99']:.4f} "
              f"max {s['max']:.4f}")
    if "k2_vs_plain_max" in res:
        print(f"  K2 against the plain samplers: max |Δ| {res['k2_vs_plain_max']:.3g}, "
              f"same mode and level: {res['k2_vs_plain_same_choice']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pose", default="interior")
    ap.add_argument("--fits", action="store_true")
    ap.add_argument("--field-err", action="store_true")
    ap.add_argument("--max-batches", type=int, default=16,
                    help="engaged batches of --field-err (0: every one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.fits or args.field_err):
        args.fits = True
    geom = batch_geometry(args.pose, args.device)
    if args.fits:
        _print_fits(args.pose, run_fits(geom))
    if args.field_err:
        _print_field_err(args.pose, run_field_err(geom, args.max_batches or None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
