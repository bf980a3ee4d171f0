"""GPU smoke run of the PyTorch/CUDA port's main paths.

Renders the demo scene through the port (``godot_atmosphere_shader_tpu_torch``)
on one CUDA card and checks every step:

1. device: a CUDA card must be present; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the megakernel from ``csrc/megakernel.cu`` with ``nvcc``
   (``sm_90a``) and prints the compiler's register report;
3. kernel against plain, small: at 256×384, ``no_clouds``/avatar,
   ``clouds``/avatar, ``clouds_high``/avatar and ``clouds_high``/interior
   through the kernel and through its plain PyTorch version on the same
   CUDA inputs (cloud tolerance: p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤ 1e-4, at most
   0.1 % of pixels above 1e-2);
3b. texture mode, small: K2 alone (``megakernel.sample_batches``) against
   the plain samplers on the planes of ``tests/test_torch_texsample.py``
   (same mode and level, atol 2e-6); then the ``clouds_high`` texture scene
   (textures baked on the card) at avatar and interior, 256×384, kernel
   against plain at the cloud tolerance;
4. the procedural slice at 1080p: ``Scene.render`` for
   ``clouds_high``/avatar, ``clouds_high``/interior and ``clouds``/avatar,
   with the launch counters showing that every frame went through the
   kernel and none through the plain path.  Each frame is then held against
   the plain version on the same inputs (cloud tolerance), and
   ``clouds_high``/avatar also against the committed 1080p block signature
   ``tests/golden_1080p_sig.npz`` (block mean ≤ 3e-3, block max ≤ 3e-2);
4b. the texture slice at 1080p: ``Scene.render`` of the ``clouds_high``
   texture scene at avatar (the JAX bench cell 6) and interior, through the
   texture instance only (counters), each held against the plain version
   (cloud tolerance); the one-off bake and pyramid times; the card's bake
   against the port's CPU bake at 16³ and 32² faces (atol 1e-5);
5. timing at 1080p with CUDA events: kernel launches alone, ``Scene.render``
   end to end (``update`` per frame) and the plain version; the device's
   idle share during ``Scene.render`` from a ``torch.profiler`` trace.

Prints a JSON line describing each kernel (with its roofline bound from
this run's work counters), then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Run from the repository root: ``python3 chip_smoke.py``
(``--quick`` stops after phase 3b).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SIG_PATH = os.path.join(ROOT, "tests", "golden_1080p_sig.npz")
SIG_BLOCK = (8, 128)
SIG_MEAN_TOL = 3e-3
SIG_MAX_TOL = 3e-2
CHECK_SIZE = (256, 384)
FULL_SIZE = (1080, 1920)
CHECK_CASES = (("no_clouds", "avatar"), ("clouds", "avatar"),
               ("clouds_high", "avatar"), ("clouds_high", "interior"))
TEXTURE_POSES = ("avatar", "interior")
K2_ATOL = 2e-6
BAKE_ATOL = 1e-5
KERNEL_FRAMES = 20
PLAIN_FRAMES = 3

# One H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, HBM rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Arithmetic operations per unit of work, counted by hand from
# csrc/megakernel.cu (one per add, multiply, compare, select, integer op or
# special function; a fused multiply-add counts 2; loads count 0).  The
# kernel's work counters say how many units this run's inputs needed.
OPS_PIXEL = 260            # ray, opaque pass, shell and ground hits, composite
OPS_ATMOSPHERE = 2740      # 8 steps of v2 with 2 × 8-node analytic sun depth
OPS_COVERAGE_KNOT = 4020   # procedural: 3-octave warp + 5-octave simplex FBM
OPS_STEP = 115             # one march step with knot-interpolated fields
OPS_SHAPE_NOISE = 392      # procedural shape field (3-octave ridged value)
OPS_TEX3D = 110            # trilinear sample, position and footprint pass
OPS_TEX3D_FLOOR = 57       # nearest floor-level sample
OPS_LATLONG = 205          # polynomial (u, v) twice and a bilinear sample
OPS_LATLONG_FLOOR = 190


def log(*args):
    print(*args, flush=True)


def cloud_deltas(got: np.ndarray, ref: np.ndarray) -> dict:
    """The cloud tolerance's statistics over all color and alpha values."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    per_pixel = d.reshape(d.shape[0], d.shape[1], -1).max(axis=-1)
    worst = np.unravel_index(int(per_pixel.argmax()), per_pixel.shape)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "p999": float(np.percentile(d, 99.9)),
            "frac_above_1e-2": float((per_pixel > 1e-2).mean()),
            "worst_pixel": [int(worst[0]), int(worst[1])]}


def cloud_tolerance_ok(st: dict) -> bool:
    return (st["p999"] <= 1e-3 and st["mean"] <= 1e-4
            and st["frac_above_1e-2"] <= 1e-3)


def frame_array(out: dict) -> np.ndarray:
    """color (H, W, 3) and alpha stacked to (H, W, 4) on the host."""
    return torch.cat([out["color"], out["alpha"][..., None]], dim=-1).cpu().numpy()


def check_frame(img: np.ndarray, what: str):
    if not np.isfinite(img).all():
        raise RuntimeError(f"{what}: non-finite values")
    a = img[..., 3]
    if a.min() < 0.0 or a.max() > 1.0:
        raise RuntimeError(f"{what}: alpha outside [0, 1] ({a.min()}, {a.max()})")
    if float(img[..., :3].max()) <= 0.0:
        raise RuntimeError(f"{what}: blank frame")


def block_signature(img: np.ndarray):
    """Per-(8, 128)-block (mean, max) of an (H, W, 3) frame, as float16."""
    bh, bw = SIG_BLOCK
    h, w, c = img.shape
    blocks = img.reshape(h // bh, bh, w // bw, bw, c)
    return (blocks.mean(axis=(1, 3)).astype(np.float16),
            blocks.max(axis=(1, 3)).astype(np.float16))


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def scene_and_camera(variant, pose, device, t=0.5, textures=None):
    """The demo scene; ``textures`` (shape, cubemap) selects texture mode."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_demo_scene,
                                                               demo_camera)

    scene = build_demo_scene(variant, procedural=textures is None, device=device,
                             textures=textures)
    cam = demo_camera(pose, device=device)
    scene.update(t, cam)
    return scene, cam


def frame_inputs(scene, cam):
    """What Scene.render hands the kernel wrapper for this frame: params,
    config (texture mode: with its pyramid metas), camera, opaque scene and
    the pyramid tables (None for procedural fields)."""
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    return (params[0], config, cam, scene.opaque), tex


def time_cuda(fn, frames: int, warmup: int = 2) -> float:
    """Milliseconds per call over ``frames`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(frames):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def device_busy_ms(fn, frames: int, first: int) -> tuple:
    """``(busy, megakernel)`` device milliseconds per call in a
    ``torch.profiler`` trace of ``frames`` calls: the union of all device
    intervals (kernels and copies), and the megakernel's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            fn(first + i)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    kernel = sum(e.time_range.elapsed_us() for e in events if "megakernel" in e.name)
    return busy / 1e3 / frames, kernel / 1e3 / frames


def roofline(work: dict, config, height: int, width: int, table_bytes: int = 0) -> dict:
    """The least time the card could take for this frame's work: the
    larger of its operations over the fp32 peak and its bytes (outputs
    written once, blue noise and pyramids read once) over the HBM rate."""
    steps = config.cloud_steps
    textured = table_bytes > 0
    ops = (work["pixels"] * OPS_PIXEL + work["atmosphere"] * OPS_ATMOSPHERE
           + work["march"] * steps * (OPS_STEP + (0 if textured else OPS_SHAPE_NOISE))
           + work["tex3d"] * OPS_TEX3D + work["tex3d_floor"] * OPS_TEX3D_FLOOR
           + work["latlong"] * OPS_LATLONG + work["latlong_floor"] * OPS_LATLONG_FLOOR)
    if not textured:
        ops += work["knot_groups"] * (config.cloud_coverage_knots + 1) * OPS_COVERAGE_KNOT
    nbytes = height * width * 16 + 256 * 256 * 4 + table_bytes
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# -- K2 alone: the planes of tests/test_torch_texsample.py ----------------------

# (name, texture size, lo, extent, rows, sampler kwargs)
K2_TEX3D_CASES = (
    ("windowed_level0", 32, (0.47, 0.52, 0.31), (0.06, 0.06, 0.06), 16,
     dict(window_rows=48, band_rows=0)),
    ("minified", 64, (0.1, 0.1, 0.1), (0.35, 0.35, 0.35), 16,
     dict(window_rows=48, band_rows=0)),
    ("banded", 64, (20.2 / 64, 33.1 / 64, 11.4 / 64), (3.0 / 64, 3.0 / 64, 5.0 / 64), 16,
     dict(window_rows=16, band_rows=16)),
    ("slice_cap_declines", 64, (10.0 / 64, 10.0 / 64, 0.05), (2.0 / 64, 2.0 / 64, 0.4), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=8)),
    ("floor_on_straddle", 32, (0.95, 0.4, 0.6), (0.1, 0.05, 0.05), 16,
     dict(window_rows=48, band_rows=0)),
    ("demo_settings_floor", 64, (0.3, 0.9, 0.2), (0.2, 0.2, 0.2), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=32)),
)
# (name, (theta0, phi0, span))
K2_LATLONG_CASES = (("windowed", (0.3, 0.2, 0.02)), ("windowed_minified", (0.3, 0.2, 0.3)),
                    ("floor_on_seam", (np.pi - 0.05, -0.1, 0.1)))


def k2_check(device) -> float:
    """K2's device functions against the plain samplers, one batch per
    case; returns the largest |Δ|."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts
    from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

    rng = np.random.default_rng(5)
    tables = {}
    for s in (32, 64):
        data, meta = ts.build_tex3d_pyramid(rng.random((s, s, s)).astype(np.float32))
        tables[s] = (torch.as_tensor(data, device=device), meta)
    worst = 0.0
    for name, size, lo, ext, rows, kw in K2_TEX3D_CASES:
        r = np.random.default_rng(sum(map(ord, name)))
        planes = [torch.as_tensor((lo[a] + ext[a] * r.random((rows, 128))).astype(np.float32),
                                  device=device) for a in range(3)]
        table, meta = tables[size]
        ref, mode, level = ts.sample_tex3d(table, meta, *planes, return_choice=True, **kw)
        got, gmode, glevel = mk.sample_batches(table, meta, *(p.reshape(1, -1) for p in planes),
                                               **kw)
        worst = max(worst, _k2_compare(f"tex3d/{name}", got.reshape(ref.shape), ref,
                                       (int(gmode[0]), int(glevel[0])), (mode, level)))
    faces = np.random.default_rng(8).random((6, 64, 64)).astype(np.float32)
    data, meta = ts.build_latlong_pyramid(faces, width=512)
    table = torch.as_tensor(data, device=device)
    for name, (theta0, phi0, span) in K2_LATLONG_CASES:
        r = np.random.default_rng(len(name))
        theta = (theta0 + span * r.random((16, 128))).astype(np.float32)
        phi = (phi0 + span * r.random((16, 128))).astype(np.float32)
        d = [torch.as_tensor(c.astype(np.float32), device=device) for c in
             (np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta))]
        ref, mode, level = ts.sample_latlong(table, meta, Vec3(*d), return_choice=True)
        got, gmode, glevel = mk.sample_batches(table, meta, *(c.reshape(1, -1) for c in d))
        worst = max(worst, _k2_compare(f"latlong/{name}", got.reshape(ref.shape), ref,
                                       (int(gmode[0]), int(glevel[0])), (mode, level)))
    return worst


def _k2_compare(what, got, ref, got_choice, ref_choice) -> float:
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    log(f"[k2] {what}: mode/level kernel {got_choice} plain {ref_choice}, max |Δ| {err:.3g}")
    if got_choice != ref_choice or not err <= K2_ATOL:
        raise RuntimeError(f"K2 disagrees with its plain version on {what}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the texture-mode checks at 256×384 (phase 3b)")
    args = ap.parse_args(argv)

    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs one GPU")
    device = torch.device("cuda", 0)
    card = smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from godot_atmosphere_shader_tpu_torch.models.demo import (SHAPE_NOISE_BAKE,
                                                               COVERAGE_NOISE,
                                                               COVERAGE_SCALE,
                                                               bake_demo_textures)
    from godot_atmosphere_shader_tpu_torch.ops import sampling
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    path, ptxas = mk.build(ptxas_info=True)
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
    for line in ptxas.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "stack", "smem")):
            log(f"[ptxas] {line.strip()}")
    mk.load_library()

    # -- 3. kernel against plain, small --------------------------------------
    h, w = CHECK_SIZE
    for variant, pose in CHECK_CASES:
        scene, cam = scene_and_camera(variant, pose, device)
        inputs, _ = frame_inputs(scene, cam)
        got = frame_array(mk.render_frame_megakernel(*inputs, h, w))
        ref = frame_array(mk.render_frame_plain(*inputs, h, w))
        torch.cuda.synchronize()
        check_frame(got, f"kernel {variant}/{pose}")
        check_frame(ref, f"plain {variant}/{pose}")
        st = cloud_deltas(got, ref)
        log(f"[check] {variant}/{pose} {h}x{w} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"kernel disagrees with plain on {variant}/{pose}")

    # -- 3b. texture mode, small: K2 alone, then the texture scene ------------
    k2_err = k2_check(device)
    torch.cuda.synchronize()
    t0 = time.time()
    textures = bake_demo_textures(device=device)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    log(f"[bake] 64^3 shape texture and 6x256^2 coverage cubemap on the card: {bake_s:.3f} s")
    for pose in TEXTURE_POSES:
        scene, cam = scene_and_camera("clouds_high", pose, device, textures=textures)
        inputs, tex = frame_inputs(scene, cam)
        got = frame_array(mk.render_frame_megakernel(*inputs, h, w, tex_data=tex))
        ref = frame_array(mk.render_frame_plain(*inputs, h, w, tex_data=tex))
        check_frame(got, f"texture kernel {pose}")
        check_frame(ref, f"texture plain {pose}")
        st = cloud_deltas(got, ref)
        log(f"[check] clouds_high texture/{pose} {h}x{w} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"texture kernel disagrees with plain on {pose}")
    if args.quick:
        return 1

    # -- 4. the procedural slice at 1080p through Scene.render -----------------
    H, W = FULL_SIZE
    runs = {}
    mk.counters.reset()
    for variant, pose in (("clouds_high", "avatar"), ("clouds_high", "interior"),
                          ("clouds", "avatar")):
        scene, cam = scene_and_camera(variant, pose, device)
        runs[(variant, pose)] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    launches, plain = mk.counters.megakernel_launches, mk.counters.plain_calls
    log(f"[slice] counters after 3 Scene.render frames: kernel {launches}, "
        f"texture {mk.counters.texture_launches}, plain {plain}")
    if launches != 3 or plain != 0 or mk.counters.texture_launches != 0:
        raise RuntimeError("the 1080p frames did not all go through the kernel")
    max_err = 0.0
    for (variant, pose), (scene, cam, out) in runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p {variant}/{pose}")
        log(f"[slice] {variant}/{pose} 1080p: mean {img[..., :3].mean():.6f} "
            f"alpha mean {img[..., 3].mean():.6f}")
        ref = frame_array(mk.render_frame_plain(*frame_inputs(scene, cam)[0], H, W))
        check_frame(ref, f"plain 1080p {variant}/{pose}")
        st = cloud_deltas(img, ref)
        log(f"[slice] {variant}/{pose} 1080p kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"1080p kernel disagrees with plain on {variant}/{pose}")
        max_err = max(max_err, st["max"])
    img = frame_array(runs[("clouds_high", "avatar")][2])[..., :3]
    mean_sig, max_sig = block_signature(img)
    ref = np.load(SIG_PATH)
    dmean = np.abs(mean_sig.astype(np.float32) - ref["mean"].astype(np.float32))
    dmax = np.abs(max_sig.astype(np.float32) - ref["max"].astype(np.float32))
    log(f"[signature] block mean delta max {dmean.max():.6g} (tol {SIG_MEAN_TOL}), "
        f"block max delta max {dmax.max():.6g} (tol {SIG_MAX_TOL}), "
        f"blocks over: mean {int((dmean > SIG_MEAN_TOL).sum())}, "
        f"max {int((dmax > SIG_MAX_TOL).sum())}")
    for name, d in (("mean", dmean), ("max", dmax)):
        worst = np.argsort(d.reshape(-1))[::-1][:5]
        for f in worst:
            by, bx, c = np.unravel_index(f, d.shape)
            log(f"[signature]   worst block-{name}: rows {by * 8}-{by * 8 + 7} "
                f"cols {bx * 128}-{bx * 128 + 127} ch {c}: {d[by, bx, c]:.6g}")
    if dmean.max() > SIG_MEAN_TOL or dmax.max() > SIG_MAX_TOL:
        raise RuntimeError("1080p frame disagrees with the committed signature")

    # -- 4b. the texture slice at 1080p through Scene.render ---------------------
    tex_runs = {}
    pyramid_s = {}
    mk.counters.reset()
    for pose in TEXTURE_POSES:
        scene, cam = scene_and_camera("clouds_high", pose, device, textures=textures)
        torch.cuda.synchronize()
        t0 = time.time()
        _, params, configs = scene._sorted_layers(cam)
        scene._texture_plan(params[0], configs[0])  # builds and uploads the pyramids
        torch.cuda.synchronize()
        pyramid_s[pose] = time.time() - t0
        tex_runs[pose] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    tex_launches = mk.counters.texture_launches
    log(f"[texture] counters after 2 Scene.render frames: kernel {mk.counters.megakernel_launches}, "
        f"texture {tex_launches}, plain {mk.counters.plain_calls}")
    if tex_launches != 2 or mk.counters.megakernel_launches != 2 or mk.counters.plain_calls:
        raise RuntimeError("the 1080p texture frames did not all go through the texture kernel")
    log(f"[texture] one-off set-up: bake {bake_s:.3f} s; pyramid build and upload "
        + ", ".join(f"{p} {s:.3f} s" for p, s in pyramid_s.items())
        + " (cold: avatar; interior reuses nothing, it is a new scene)")
    tex_err = 0.0
    for pose, (scene, cam, out) in tex_runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p texture {pose}")
        log(f"[texture] clouds_high/{pose} 1080p: mean {img[..., :3].mean():.6f} "
            f"alpha mean {img[..., 3].mean():.6f}")
        inputs, tex = frame_inputs(scene, cam)
        ref = frame_array(mk.render_frame_plain(*inputs, H, W, tex_data=tex))
        check_frame(ref, f"plain 1080p texture {pose}")
        st = cloud_deltas(img, ref)
        log(f"[texture] clouds_high/{pose} 1080p kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"1080p texture kernel disagrees with plain on {pose}")
        tex_err = max(tex_err, st["max"])
    for size, bake in ((16, lambda dev: sampling.bake_noise_texture3d(SHAPE_NOISE_BAKE, 16,
                                                                      device=dev)),
                       (32, lambda dev: sampling.bake_noise_cubemap(COVERAGE_NOISE,
                                                                    COVERAGE_SCALE, 32,
                                                                    device=dev))):
        err = float((bake(device).cpu() - bake("cpu")).abs().max())
        log(f"[bake] card vs CPU bake at {size}: max |Δ| {err:.3g} (atol {BAKE_ATOL})")
        if not err <= BAKE_ATOL:
            raise RuntimeError(f"the card's bake disagrees with the CPU bake at {size}")

    # -- 5. timing -------------------------------------------------------------
    timings, bounds = {}, {}
    cases = [("clouds_high", "avatar", None), ("clouds_high", "interior", None),
             ("clouds", "avatar", None)] + [("clouds_high", p, textures) for p in TEXTURE_POSES]
    for variant, pose, tx in cases:
        label = f"{variant}{'/texture' if tx is not None else ''}/{pose}"
        scene, cam = scene_and_camera(variant, pose, device, textures=tx)
        inputs, tex = frame_inputs(scene, cam)
        struct = mk.frame_constants(*inputs, H, W)
        tex_launch = None if tex is None else (mk.tex_constants(inputs[1]), *tex)
        color = torch.empty((H, W, 3), device=device)
        alpha = torch.empty((H, W), device=device)

        def launch(i):
            mk.launch(struct, color, alpha, tex=tex_launch)

        def frame(i):
            scene.update(0.5 + 0.05 * i, cam)
            scene.render(cam, H, W)

        def plain(i):
            scene.update(0.5 + 0.05 * i, cam)
            ins, tx_data = frame_inputs(scene, cam)
            mk.render_frame_plain(*ins, H, W, tex_data=tx_data)

        t = {"kernel_ms": time_cuda(launch, KERNEL_FRAMES),
             "scene_ms": time_cuda(frame, KERNEL_FRAMES),
             "plain_ms": time_cuda(plain, PLAIN_FRAMES, warmup=1)}
        for k in list(t):
            t[k.replace("_ms", "_mrays")] = H * W / (t[k] * 1e-3) / 1e6
        busy, kernel = device_busy_ms(frame, KERNEL_FRAMES, first=2 + KERNEL_FRAMES)
        # a trace without device time measures nothing: no idle share then
        t["scene_device_busy_ms"] = busy
        t["scene_megakernel_device_ms"] = kernel
        t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
        work = mk.work_counts(struct, color, alpha, tex=tex_launch)
        table_bytes = 0 if tex is None else sum(x.numel() * 4 for x in tex)
        bounds[label] = dict(roofline(work, inputs[1], H, W, table_bytes), work=work)
        t["bound_ms"] = bounds[label]["bound_ms"]
        timings[label] = t
        log(f"[time] {label} 1080p on {card}: {json.dumps(t)}")
        log(f"[bound] {label}: {json.dumps(bounds[label])}")
    log(f"[time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    flagship, tex_flagship = "clouds_high/avatar", "clouds_high/texture/avatar"
    log(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timings[flagship]["kernel_ms"],
        "plain_ms": timings[flagship]["plain_ms"],
        "bound_ms": bounds[flagship]["bound_ms"],
        "bound_by": bounds[flagship]["bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_tex",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/texsample.py:348, "
                     "godot_atmosphere_shader_tpu/ops/pallas/texsample.py:544 (inside "
                     "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171)"),
        "launches": tex_launches,
        "max_abs_err": tex_err,
        "k2_alone_max_abs_err": k2_err,
        "ms": timings[tex_flagship]["kernel_ms"],
        "plain_ms": timings[tex_flagship]["plain_ms"],
        "bound_ms": bounds[tex_flagship]["bound_ms"],
        "bound_by": bounds[tex_flagship]["bound_by"],
        "library_ms": None,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
