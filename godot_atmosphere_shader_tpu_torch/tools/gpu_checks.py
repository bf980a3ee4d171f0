"""The port's on-card gate, the twin of the JAX package's ``tools/tpu_checks.py``.

Runs on one CUDA card and writes a JSON verdict, without the timing phases
of ``chip_smoke.py``::

    python -m godot_atmosphere_shader_tpu_torch.tools.gpu_checks [-o GPU_CHECKS.json] [--size 256x384]

Exits 1 if any check fails and 2 without a CUDA card.  The checks, in the
JAX file's order:

1. each of the seven variant poses (``VARIANT_POSES``): ``Scene.render``
   through the kernel (the launch counters: the planned K1 launches, no
   plain call) against the plain chain on the same CUDA inputs, p99.9 of
   |Δ| ≤ ``ATOL`` and max ≤ ``ATOL_MAX`` on color and alpha; finite, alpha
   in [0, 1], a non-trivial frame.  Where the gate's bound fails, what
   one ulp of the camera (its position or its orientation) moves the plain
   frame by is measured first; where that move itself breaks the bound
   the variant is held to the strictest tolerance the move keeps
   (:func:`ulp_tolerance_ok`), and the verdict names it;
2. texture mode: the texture kernel's ``clouds``/avatar frame against the
   exact-sampling plain frame (shape and coverage interpolated per step, no
   pyramids): lit-mask agreement above 0.9, mean brightness within 0.05;
3. the banded sampler: K2 alone on a 1:1 close-up of a 64³ texture, banded,
   against exact trilinear (max |Δ| < 1e-5), banding engaged;
4. the sharded band: the row-sharded frame over a mesh of the cards there
   are against the whole frame, Δ = 0 exactly; 2 shards of the local mesh
   beside it (128 rows each at the default size), at the cloud tolerance;
5. the flagship's 1080p block signature and the everything-on frame's
   (``tests/golden_1080p_sig.npz``, ``golden_allon_sig.npz``, written by
   the JAX package and never rewritten here), the everything-on frame with
   the demo glow finite, and the everything-on frame row-sharded against
   the whole frame (max |Δ| ≤ 1e-5).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..models.demo import bake_demo_textures, build_demo_scene, demo_camera
from ..models.scene import PlanetAtmosphere
from ..ops.kernels import megakernel as mk
from ..ops.kernels import texsample as ts
from ..ops.sampling import sample_trilinear_repeat
from ..parallel import sharding
from ..render.glow import GlowSettings
from ..render.renderer import render_frame

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIG_PATH = os.path.join(ROOT, "tests", "golden_1080p_sig.npz")
ALLON_SIG_PATH = os.path.join(ROOT, "tests", "golden_allon_sig.npz")

# Kernel against plain, as the JAX gate holds compiled Mosaic against XLA
# (tools/tpu_checks.py:47-48): the bulk of the values (p99.9) to ATOL, every
# value to ATOL_MAX (about one uint8 level)
ATOL = 1e-3
ATOL_MAX = 4e-3

VARIANT_POSES = [
    ("no_clouds", "exterior"),
    ("clouds", "avatar"),
    ("clouds_high", "interior"),
    ("clouds_high_rm", "space"),
    ("v1_no_clouds", "exterior"),
    ("v1_clouds", "avatar"),
    ("v1_clouds_high", "interior"),
]

SIG_BLOCK = (8, 128)  # fine enough to localize tile-boundary artifacts
SIG_MEAN_TOL = 3e-3
SIG_MAX_TOL = 3e-2
#: the banded sampler's bound against exact trilinear (tools/tpu_checks.py:153)
BANDED_TOL = 1e-5
#: the sharded everything-on frame against the whole one (tools/tpu_checks.py:417)
SHARDED_ALLON_TOL = 1e-5
#: shards of the local mesh beside the sharded band check (128 rows each
#: at the default size)
LOCAL_SHARDS = 2
#: the everything-on frame's moon (tools/tpu_checks.py:336-339)
MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))


# -- statistics and tolerances --------------------------------------------------------


def frame_array(out: dict) -> np.ndarray:
    """color (H, W, 3) and alpha stacked to (H, W, 4) on the host."""
    return torch.cat([out["color"], out["alpha"][..., None]], dim=-1).cpu().numpy()


def gate_deltas(got: np.ndarray, ref: np.ndarray) -> dict:
    """The JAX gate's statistics of two (H, W, 4) frames: max and p99.9 of
    |Δ| on color and on alpha."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    c, a = d[..., :3], d[..., 3]
    return {"max_color_diff": float(c.max()), "max_alpha_diff": float(a.max()),
            "p999_color_diff": float(np.percentile(c, 99.9)),
            "p999_alpha_diff": float(np.percentile(a, 99.9))}


def gate_ok(st: dict) -> bool:
    return (st["p999_color_diff"] <= ATOL and st["p999_alpha_diff"] <= ATOL
            and st["max_color_diff"] <= ATOL_MAX and st["max_alpha_diff"] <= ATOL_MAX)


def frame_flags(img: np.ndarray) -> dict:
    """Finite, alpha in [0, 1] (v2 caps at 0.99 + dither; v1 and the cloud
    blend reach 1.0), and a frame the atmosphere shaded."""
    alpha = img[..., 3]
    return {"finite": bool(np.isfinite(img).all()),
            "alpha_in_range": bool((alpha >= 0).all() and (alpha <= 1.0 + 1e-6).all()),
            "nontrivial": bool(alpha.max() > 0.01)}


def cloud_deltas(got: np.ndarray, ref: np.ndarray) -> dict:
    """The cloud tolerance's statistics over all color and alpha values."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    per_pixel = d.reshape(d.shape[0], d.shape[1], -1).max(axis=-1)
    worst = np.unravel_index(int(per_pixel.argmax()), per_pixel.shape)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "p99": float(np.percentile(d, 99.0)), "p999": float(np.percentile(d, 99.9)),
            "frac_above_1e-2": float((per_pixel > 1e-2).mean()),
            "worst_pixel": [int(worst[0]), int(worst[1])]}


def cloud_tolerance_ok(st: dict) -> bool:
    return (st["p999"] <= 1e-3 and st["mean"] <= 1e-4
            and st["frac_above_1e-2"] <= 1e-3)


def detail_tolerance_ok(st: dict) -> bool:
    """Full-quality frames: the detail field samples the shape field at
    pos·15, so one ulp of a march position moves a cloud pixel by ~1e-3.
    p99 takes the place of p99.9; the rest is the cloud tolerance."""
    return (st["p99"] <= 1e-3 and st["mean"] <= 1e-4
            and st["frac_above_1e-2"] <= 1e-3)


def conditioned_tolerance_ok(st: dict, ulp: dict) -> bool:
    """Kernel against plain on a frame that one ulp of the camera moves
    beyond the cloud tolerance (``ulp``: that move of the plain frame, so
    the kernel under test sets no bound of its own): each statistic of the
    cloud tolerance held to the larger of its bound and twice what that one
    ulp moves it by (two frames rounded apart, each within such a move of
    the exact one), as the gas giant's max |Δ| is."""
    return (st["p999"] <= max(1e-3, 2.0 * ulp["p999"])
            and st["mean"] <= max(1e-4, 2.0 * ulp["mean"])
            and st["frac_above_1e-2"] <= max(1e-3, 2.0 * ulp["frac_above_1e-2"]))


def ulp_tolerance_ok(st: dict, ulp: dict) -> bool:
    """Kernel against plain on a frame whose conditioning one ulp of the
    camera measured first (``ulp``: the plain frame's move): the strictest
    tolerance that move does not itself break: the cloud tolerance; else,
    where only p99.9 breaks (a few ill-conditioned pixels: cellular cell
    edges), p99 in its place; else :func:`conditioned_tolerance_ok`."""
    if cloud_tolerance_ok(ulp):
        return cloud_tolerance_ok(st)
    if detail_tolerance_ok(ulp):
        return detail_tolerance_ok(st)
    return conditioned_tolerance_ok(st, ulp)


def ulp_tolerance_name(ulp: dict) -> str:
    """The name of the tolerance :func:`ulp_tolerance_ok` holds to."""
    return ("cloud" if cloud_tolerance_ok(ulp) else "p99 for p99.9"
            if detail_tolerance_ok(ulp) else "conditioned")


def transform_ulp_moves(cam) -> tuple:
    """One ulp either way of each nonzero entry of the camera's transform,
    ``(row, column, direction)``: its position and its orientation, whose
    rounding decides the ray directions (a silhouette pixel can flip on
    either)."""
    v2w = cam.view_to_world
    return tuple((r, c, s) for r in range(3) for c in range(4) for s in (1, -1)
                 if float(v2w[r, c]) != 0.0)


def camera_ulp_move(scene, cam, h: int, w: int, base: np.ndarray, t: float = 0.5) -> dict:
    """What one ulp of the camera moves the scene's plain frame by
    (``base``: the frame at ``cam``): per statistic of :func:`gate_deltas`
    and :func:`cloud_deltas`, the largest over :func:`transform_ulp_moves`."""
    worst = {}
    for row, col, sign in transform_ulp_moves(cam):
        v2w = cam.view_to_world.clone()
        v2w[row, col] = torch.nextafter(v2w[row, col],
                                        torch.tensor(sign * 1e9, device=v2w.device))
        moved = dataclasses.replace(cam, view_to_world=v2w)
        scene.update(t, moved)
        img = frame_array(scene.render(moved, h, w, renderer="plain"))
        st = {**gate_deltas(img, base), **cloud_deltas(img, base)}
        st.pop("worst_pixel")
        worst = {k: max(v, worst.get(k, v)) for k, v in st.items()}
    scene.update(t, cam)
    return worst


def variant_verdict(got: np.ndarray, ref: np.ndarray, ulp: dict = None) -> dict:
    """Kernel frame ``got`` against plain ``ref``, (H, W, 4) each: the
    gate's statistics and flags; ``tolerance`` "gate" (:func:`gate_ok`), or,
    where the one-ulp move ``ulp`` of the plain frame itself breaks it, the
    tolerance :func:`ulp_tolerance_ok` names, held on :func:`cloud_deltas`."""
    st = gate_deltas(got, ref)
    out = {**st, **frame_flags(got), "tolerance": "gate"}
    ok = gate_ok(st)
    if ulp is not None and not gate_ok(ulp):
        cloud = cloud_deltas(got, ref)
        out.update(tolerance=ulp_tolerance_name(ulp), cloud=cloud, ulp=ulp)
        ok = ulp_tolerance_ok(cloud, ulp)
    elif ulp is not None:
        out["ulp"] = ulp
    out["pass"] = bool(ok and out["finite"] and out["alpha_in_range"] and out["nontrivial"])
    return out


def block_signature(img: np.ndarray):
    """Per-(8, 128)-block (mean, max) signature of an (H, W, 3) frame, as
    float16 (``tools/tpu_checks.py:264``)."""
    bh, bw = SIG_BLOCK
    h, w, c = img.shape
    if h % bh or w % bw:
        raise ValueError(f"a {h}x{w} frame does not split into {bh}x{bw} blocks")
    blocks = img.reshape(h // bh, bh, w // bw, bw, c)
    return (blocks.mean(axis=(1, 3)).astype(np.float16),
            blocks.max(axis=(1, 3)).astype(np.float16))


def signature_deltas(img: np.ndarray, path: str) -> dict:
    """An (H, W, 3) frame's block signature against a committed one."""
    mean_sig, max_sig = block_signature(img)
    ref = np.load(path)
    return {"block_mean_delta": float(np.abs(mean_sig.astype(np.float32)
                                             - ref["mean"].astype(np.float32)).max()),
            "block_max_delta": float(np.abs(max_sig.astype(np.float32)
                                            - ref["max"].astype(np.float32)).max())}


def signature_ok(st: dict) -> bool:
    return st["block_mean_delta"] <= SIG_MEAN_TOL and st["block_max_delta"] <= SIG_MAX_TOL


# -- the checks ------------------------------------------------------------------------


def planned_launches(scene, cam, h: int) -> int:
    """K1 launches of ``scene.render``'s plan: one per kept layer, one more
    for the opaque-only pass when the farthest layer is banded."""
    order, params, configs = scene._sorted_layers(cam)
    _, _, kept, _, bands, _ = scene._layer_bands(order, params, configs,
                                                 (None,) * len(configs), cam, h)
    return len(kept) + int(bands is not None and bands[0] is not None)


def check_variant(variant: str, pose: str, h: int, w: int, device="cuda") -> dict:
    """``Scene.render`` through the kernel against the plain chain
    (``tools/tpu_checks.py:61``), with the launch counters."""
    scene = build_demo_scene(variant, procedural=True, device=device)
    cam = demo_camera(pose, device=device)
    scene.update(0.5, cam)
    mk.counters.reset()
    got = frame_array(scene.render(cam, h, w, renderer="kernel"))
    launches = {"k1": mk.counters.megakernel_launches, "plain": mk.counters.plain_calls,
                "planned": planned_launches(scene, cam, h)}
    ref = frame_array(scene.render(cam, h, w, renderer="plain"))
    ulp = None
    if not gate_ok(gate_deltas(got, ref)):
        ulp = camera_ulp_move(scene, cam, h, w, ref)
    out = {"variant": variant, "pose": pose, "launches": launches,
           **variant_verdict(got, ref, ulp)}
    if torch.device(device).type == "cuda":
        out["pass"] = out["pass"] and launches["k1"] == launches["planned"] and not launches["plain"]
    return out


def check_texture_mode(h: int, w: int, device="cuda", textures=None) -> dict:
    """The texture kernel's frame against the exact-sampling plain frame
    (``tools/tpu_checks.py:157``): not pixel parity (the pyramids are an
    approximation by design, PARITY #12), but the lit mask and the mean
    brightness."""
    scene = build_demo_scene("clouds", procedural=False, device=device, textures=textures)
    cam = demo_camera("avatar", device=device)
    scene.update(0.5, cam)
    mk.counters.reset()
    got = frame_array(scene.render(cam, h, w))
    launches = {"texture": mk.counters.texture_launches, "plain": mk.counters.plain_calls}
    _, params, configs = scene._sorted_layers(cam)
    exact_cfg = dataclasses.replace(configs[0], cloud_shape_interp=True,
                                    cloud_coverage_interp=True)
    ref = frame_array(render_frame(params[0], exact_cfg, cam, scene.opaque, h, w))
    lit_k = got[..., :3].mean(-1) > 0.02
    lit_x = ref[..., :3].mean(-1) > 0.02
    out = {"variant": "clouds+textures", "pose": "avatar", "launches": launches,
           "lit_mask_agreement": float((lit_k == lit_x).mean()),
           "mean_brightness_delta": abs(float(got[..., :3].mean()) - float(ref[..., :3].mean())),
           **frame_flags(got)}
    out["pass"] = bool(out["finite"] and out["alpha_in_range"] and out["nontrivial"]
                       and out["lit_mask_agreement"] > 0.9
                       and out["mean_brightness_delta"] < 0.05)
    if torch.device(device).type == "cuda":
        out["pass"] = out["pass"] and launches["texture"] == 1 and not launches["plain"]
    return out


def banded_sampler_inputs() -> tuple:
    """The JAX check's seed-7 64³ texture and its 16×128 close-up planes
    (``tools/tpu_checks.py:125-130``), as numpy float32."""
    rng = np.random.default_rng(7)
    tex = rng.random((64, 64, 64)).astype(np.float32)
    cx = (20.2 / 64 + (3.0 / 64) * rng.random((16, 128))).astype(np.float32)
    cy = (33.1 / 64 + (3.0 / 64) * rng.random((16, 128))).astype(np.float32)
    cz = (11.4 / 64 + (5.0 / 64) * rng.random((16, 128))).astype(np.float32)
    return tex, cx, cy, cz


def sample_banded(device="cuda") -> dict:
    """K2 alone (``megakernel.sample_batches``) on the banded sampler's
    planes, one batch, ``band_rows`` 16 (``on``) and 0 (``off``), and exact
    trilinear (``exact``): (16, 128) tensors; ``mode``/``level`` of each
    K2 run."""
    tex, *planes = banded_sampler_inputs()
    data, meta = ts.build_tex3d_pyramid(tex)
    table = torch.as_tensor(data, device=device)
    x, y, z = (torch.as_tensor(p, device=device) for p in planes)
    out = {}
    for name, band_rows in (("on", 16), ("off", 0)):
        v, mode, level = mk.sample_batches(table, meta, x.reshape(1, -1), y.reshape(1, -1),
                                           z.reshape(1, -1), window_rows=16,
                                           band_rows=band_rows)
        out[name] = v.reshape(x.shape)
        out[f"{name}_choice"] = (int(mode[0]), int(level[0]))
    out["exact"] = sample_trilinear_repeat(torch.as_tensor(tex, device=device), x, y, z)
    return out


def check_banded_sampler(device="cuda") -> dict:
    """A 1:1 close-up that blows the 16-row window must be restored to
    exact level-0 trilinear by the banded branch (``tools/tpu_checks.py:111``)."""
    mk.counters.reset()
    s = sample_banded(device)
    max_diff = float((s["on"] - s["exact"]).abs().max())
    engaged = bool((s["on"] - s["off"]).abs().max() > 0.0)
    return {"variant": "banded-sampler", "pose": "synthetic", "max_abs_diff": max_diff,
            "engaged": engaged, "choice": s["on_choice"], "windowed_choice": s["off_choice"],
            "launches": mk.counters.texsample_launches,
            "pass": bool(max_diff < BANDED_TOL and engaged)}


def check_sharded_band(h: int, w: int, device="cuda") -> dict:
    """The row-sharded frame against the whole frame, Δ = 0 exactly over a
    mesh of the cards there are (``tools/tpu_checks.py:205``: the algorithm
    shares nothing across pixels, so any Δ is a divergence of the launch,
    and this is not weakened to a tolerance); beside it
    :data:`LOCAL_SHARDS` shards of the local mesh, at the cloud
    tolerance."""
    scene = build_demo_scene("clouds", procedural=True, device=device)
    cam = demo_camera("avatar", device=device)
    scene.update(0.5, cam)
    atmo = scene.atmospheres[0]
    params, config = atmo.build_params(), atmo.config
    n = max(1, torch.cuda.device_count()) if torch.device(device).type == "cuda" else 1
    full = mk.render_frame_megakernel(params, config, cam, scene.opaque, h, w)["color"]
    sharded = sharding.render_frame_megakernel_sharded(params, config, cam, scene.opaque, h, w,
                                                       sharding.make_mesh(n))
    two = sharding.render_frame_megakernel_sharded(params, config, cam, scene.opaque, h, w,
                                                   sharding.make_mesh(LOCAL_SHARDS))
    delta = float((sharded - full).abs().max())
    local = cloud_deltas(two.cpu().numpy(), full.cpu().numpy())
    finite = bool(torch.isfinite(sharded).all())
    return {"variant": "sharded-band megakernel", "pose": "avatar", "n_devices": n,
            "band_vs_full_max_delta": delta, "finite": finite,
            "local_shards": LOCAL_SHARDS, "local_vs_full": local,
            "pass": bool(delta == 0.0 and finite and cloud_tolerance_ok(local))}


def check_1080p_signature(device="cuda") -> dict:
    """The flagship (``clouds_high``/avatar) at 1920×1080 through
    ``Scene.render`` against the committed block signature
    (``tools/tpu_checks.py:274``)."""
    scene = build_demo_scene("clouds_high", procedural=True, device=device)
    cam = demo_camera("avatar", device=device)
    scene.update(0.5, cam)
    img = scene.render(cam, 1080, 1920)["color"].cpu().numpy()
    out = {"variant": "clouds_high 1080p signature", "pose": "avatar",
           "finite": bool(np.isfinite(img).all()), **signature_deltas(img, SIG_PATH)}
    out["pass"] = bool(out["finite"] and signature_ok(out))
    return out


def allon_panorama() -> np.ndarray:
    """The everything-on check's own 32×64 panorama (``tools/tpu_checks.py:331-334``)."""
    return np.stack([np.tile((np.arange(64) + 0.5) / 64, (32, 1)),
                     np.tile(((np.arange(32) + 0.5) / 32)[:, None], (1, 64)),
                     np.full((32, 64), 0.25)], -1).astype(np.float32)


def everything_on_scene(device="cuda", textures=None):
    """The everything-on composite (``tools/tpu_checks.py:318``): texture
    clouds, the check's panorama, a far-mode moon with its own atmosphere;
    the demo's glow as its environment.  Returns ``(scene, camera)``."""
    scene = build_demo_scene("clouds", procedural=False, device=device, textures=textures)
    scene.opaque = dataclasses.replace(scene.opaque,
                                       panorama=torch.as_tensor(allon_panorama(), device=device))
    scene.atmospheres.append(PlanetAtmosphere(sun=scene.atmospheres[0].sun,
                                              custom_shader="no_clouds", device=device, **MOON))
    scene.environment = GlowSettings.demo()
    cam = demo_camera("avatar", device=device)
    scene.update(0.25, cam)
    return scene, cam


def check_everything_on(h: int, w: int, device="cuda", textures=None) -> dict:
    """The everything-on frame through ``Scene.render`` against the
    committed block signature, the glow on it finite
    (``tools/tpu_checks.py:345``)."""
    scene, cam = everything_on_scene(device, textures)
    out = scene.render(cam, h, w)
    img = out["color"].cpu().numpy()
    glowed = scene.apply_environment(out["color"])
    res = {"variant": "everything-on composite", "pose": "avatar",
           "finite": bool(np.isfinite(img).all()),
           "glow_finite": bool(torch.isfinite(glowed).all()),
           "nontrivial": bool(float(out["alpha"].max()) > 0.01),
           **signature_deltas(img, ALLON_SIG_PATH)}
    res["pass"] = bool(res["finite"] and res["glow_finite"] and res["nontrivial"]
                       and signature_ok(res))
    return res


def check_everything_on_sharded(h: int, w: int, device="cuda", textures=None) -> dict:
    """The everything-on frame through the sharded layer chain over a mesh
    of the cards there are against the whole chain, max |Δ| ≤ 1e-5
    (``tools/tpu_checks.py:383``)."""
    scene, cam = everything_on_scene(device, textures)
    _, params, configs = scene._sorted_layers(cam)
    plan = scene._kernel_plan(params, configs)
    if plan is None:
        raise RuntimeError("the everything-on scene has no kernel plan")
    configs, tex_data, pano_data, pano_meta = plan
    kw = dict(tex_data=tex_data, pano_data=pano_data, pano_meta=pano_meta)
    n = max(1, torch.cuda.device_count()) if torch.device(device).type == "cuda" else 1
    full = mk.render_scene_megakernel(params, configs, cam, scene.opaque, h, w, **kw)["color"]
    shard = sharding.render_scene_megakernel_sharded(params, configs, cam, scene.opaque, h, w,
                                                     sharding.make_mesh(n), **kw)["color"]
    delta = float((shard - full).abs().max())
    finite = bool(torch.isfinite(shard).all())
    return {"variant": "everything-on sharded", "pose": "avatar", "n_devices": n,
            "shard_vs_full_max_delta": delta, "finite": finite,
            "pass": bool(delta <= SHARDED_ALLON_TOL and finite)}


def run_checks(h: int = 256, w: int = 384, device="cuda", textures=None) -> list:
    """Every check in the JAX gate's order; ``textures``: the demo's baked
    ``(shape, cubemap)`` on ``device`` (baked here when ``None``)."""
    if textures is None:
        textures = bake_demo_textures(device=device)
    results = [check_variant(v, p, h, w, device) for v, p in VARIANT_POSES]
    results.append(check_texture_mode(h, w, device, textures))
    results.append(check_banded_sampler(device))
    results.append(check_sharded_band(h, w, device))
    results.append(check_1080p_signature(device))
    results.append(check_everything_on(h, w, device, textures))
    results.append(check_everything_on_sharded(h, w, device, textures))
    return results


def summary(r: dict) -> str:
    """One line of a result, as the JAX gate prints it."""
    head = f"{'ok' if r['pass'] else 'FAIL':4s} {r['variant']:24s} {r['pose']:9s}"
    if "max_color_diff" in r:
        return (f"{head} color diff {r['max_color_diff']:.2e} alpha diff "
                f"{r['max_alpha_diff']:.2e} (p99.9 {r['p999_color_diff']:.2e}, "
                f"{r['p999_alpha_diff']:.2e}; tolerance {r['tolerance']})")
    if "lit_mask_agreement" in r:
        return (f"{head} lit-mask agreement {r['lit_mask_agreement']:.3f} mean delta "
                f"{r['mean_brightness_delta']:.3f}")
    if "engaged" in r:
        return f"{head} max |Δ| vs exact trilinear {r['max_abs_diff']:.2e} (engaged={r['engaged']})"
    if "band_vs_full_max_delta" in r:
        return (f"{head} band-vs-full max Δ {r['band_vs_full_max_delta']:.2e} "
                f"({r['n_devices']} device(s)); {r['local_shards']} local shards max Δ "
                f"{r['local_vs_full']['max']:.2e}")
    if "shard_vs_full_max_delta" in r:
        return (f"{head} shard-vs-full max Δ {r['shard_vs_full_max_delta']:.2e} "
                f"({r['n_devices']} device(s))")
    return (f"{head} block mean Δ {r['block_mean_delta']:.2e} max Δ "
            f"{r['block_max_delta']:.2e}" + (f" (glow finite={r['glow_finite']})"
                                              if "glow_finite" in r else ""))


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", default="GPU_CHECKS.json")
    ap.add_argument("--size", default="256x384", help="HxW per variant (default 256x384)")
    args = ap.parse_args(argv)
    h, w = (int(x) for x in args.size.split("x"))
    if not torch.cuda.is_available():
        print("ERROR: needs a CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    device = card_name()
    results = run_checks(h, w)
    for r in results:
        print(summary(r))
    verdict = {"device": device, "size": f"{h}x{w}", "atol": ATOL, "atol_max": ATOL_MAX,
               "all_pass": all(r["pass"] for r in results), "results": results}
    with open(args.output, "w") as f:
        json.dump(verdict, f, indent=1)
    print(f"wrote {args.output}: all_pass={verdict['all_pass']}")
    return 0 if verdict["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
