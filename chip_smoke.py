"""GPU smoke run of the PyTorch/CUDA port's main path.

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
4. the slice at 1080p: ``Scene.render`` for ``clouds_high``/avatar,
   ``clouds_high``/interior and ``clouds``/avatar, with the launch counters
   showing that every frame went through the kernel and none through the
   plain path.  Each frame is then held against the plain version on the
   same inputs (cloud tolerance), and ``clouds_high``/avatar also against
   the committed 1080p block signature ``tests/golden_1080p_sig.npz``
   (block mean ≤ 3e-3, block max ≤ 3e-2);
5. timing at 1080p with CUDA events: kernel launches alone, ``Scene.render``
   end to end (``update`` per frame) and the plain version; the device's
   idle share during ``Scene.render`` from a ``torch.profiler`` trace.

Prints a JSON line describing each kernel, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Run from the repository root: ``python3 chip_smoke.py``
(``--quick`` stops after phase 3).
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
KERNEL_FRAMES = 20
PLAIN_FRAMES = 3


def log(*args):
    print(*args, flush=True)


def cloud_deltas(got: np.ndarray, ref: np.ndarray) -> dict:
    """The cloud tolerance's statistics over all color and alpha values."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    per_pixel = d.reshape(d.shape[0], d.shape[1], -1).max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "p999": float(np.percentile(d, 99.9)),
            "frac_above_1e-2": float((per_pixel > 1e-2).mean())}


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


def scene_and_camera(variant, pose, device, t=0.5):
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_demo_scene,
                                                               demo_camera)

    scene = build_demo_scene(variant, device=device)
    cam = demo_camera(pose, device=device)
    scene.update(t, cam)
    return scene, cam


def frame_inputs(scene, cam):
    """What Scene.render hands the kernel wrapper for this frame."""
    _, params, configs = scene._sorted_layers(cam)
    return params[0], configs[0], cam, scene.opaque


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-against-plain phase")
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

    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    path, ptxas = mk.build(ptxas_info=True)
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log(f"[ptxas] {line.strip()}")
    mk.load_library()

    # -- 3. kernel against plain, small --------------------------------------
    h, w = CHECK_SIZE
    for variant, pose in CHECK_CASES:
        scene, cam = scene_and_camera(variant, pose, device)
        inputs = frame_inputs(scene, cam)
        got = frame_array(mk.render_frame_megakernel(*inputs, h, w))
        ref = frame_array(mk.render_frame_plain(*inputs, h, w))
        torch.cuda.synchronize()
        check_frame(got, f"kernel {variant}/{pose}")
        check_frame(ref, f"plain {variant}/{pose}")
        st = cloud_deltas(got, ref)
        log(f"[check] {variant}/{pose} {h}x{w} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"kernel disagrees with plain on {variant}/{pose}")
    if args.quick:
        return 1

    # -- 4. the slice at 1080p through Scene.render --------------------------
    H, W = FULL_SIZE
    runs = {}
    mk.counters.reset()
    for variant, pose in (("clouds_high", "avatar"), ("clouds_high", "interior"),
                          ("clouds", "avatar")):
        scene, cam = scene_and_camera(variant, pose, device)
        runs[(variant, pose)] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    launches, plain = mk.counters.megakernel_launches, mk.counters.plain_calls
    log(f"[slice] counters after 3 Scene.render frames: kernel {launches}, plain {plain}")
    if launches != 3 or plain != 0:
        raise RuntimeError("the 1080p frames did not all go through the kernel")
    max_err = 0.0
    for (variant, pose), (scene, cam, out) in runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p {variant}/{pose}")
        log(f"[slice] {variant}/{pose} 1080p: mean {img[..., :3].mean():.6f} "
            f"alpha mean {img[..., 3].mean():.6f}")
        ref = frame_array(mk.render_frame_plain(*frame_inputs(scene, cam), H, W))
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

    # -- 5. timing -------------------------------------------------------------
    timings = {}
    for variant, pose in (("clouds_high", "avatar"), ("clouds_high", "interior"),
                          ("clouds", "avatar")):
        scene, cam = scene_and_camera(variant, pose, device)
        struct = mk.frame_constants(*frame_inputs(scene, cam), H, W)
        color = torch.empty((H, W, 3), device=device)
        alpha = torch.empty((H, W), device=device)

        def launch(i):
            mk.launch(struct, color, alpha)

        def frame(i):
            scene.update(0.5 + 0.05 * i, cam)
            scene.render(cam, H, W)

        def plain(i):
            scene.update(0.5 + 0.05 * i, cam)
            mk.render_frame_plain(*frame_inputs(scene, cam), H, W)

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
        timings[f"{variant}/{pose}"] = t
        log(f"[time] {variant}/{pose} 1080p on {card}: {json.dumps(t)}")
    log(f"[time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    flagship = timings["clouds_high/avatar"]
    log(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": flagship["kernel_ms"],
        "plain_ms": flagship["plain_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
