"""Command-line tools: render, fly, fit, bake-lut and export-cubemap.

    python -m godot_atmosphere_shader_tpu_torch.cli render --variant clouds --pose space -o out.png
    python -m godot_atmosphere_shader_tpu_torch.cli render --scene planet.tscn --stats 8 -o out.png
    python -m godot_atmosphere_shader_tpu_torch.cli fly --taa --frames 8 -o flight_
    python -m godot_atmosphere_shader_tpu_torch.cli fit --variant no_clouds --steps 60
    python -m godot_atmosphere_shader_tpu_torch.cli bake-lut --radius 100 --height 8 -o lut.npy
    python -m godot_atmosphere_shader_tpu_torch.cli export-cubemap -o coverage.png

Counterpart of ``godot_atmosphere_shader_tpu/cli.py``, with its arguments
and defaults: the reference's editor plugin (the inspector's bake button,
``tools/plugin.gd``) and its preview as offline commands.  Everything runs
on the card unless ``--device cpu`` asks for the CPU; ``render
--renderer`` takes ``Scene.render``'s ``auto``, ``kernel`` or ``plain``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _png(path: str, color: torch.Tensor) -> None:
    """A linear frame (H, W, 3) clamped to [0, 1], sRGB-encoded, as an 8-bit
    PNG."""
    from .utils.color import linear_to_srgb
    from .utils.image_io import to_uint8, write_png

    write_png(path, to_uint8(linear_to_srgb(torch.clamp(color, 0.0, 1.0)).cpu().numpy()))


def cmd_render(args) -> None:
    from .models.demo import build_demo_scene, demo_camera

    device = args.device
    camera_of = demo_camera
    if args.scene:
        from .models.tscn import load_tscn

        result = load_tscn(args.scene, procedural=not args.textures, device=device)
        scene = result.scene
        for note in result.skipped:
            print(f"  (skipped: {note})")
    elif args.variant == "gas_giant":
        from .models.demo import build_gas_giant_scene, gas_giant_camera

        scene = build_gas_giant_scene(device=device)
        if args.pose in ("avatar", "sunrise", "sunward"):
            raise SystemExit(f"pose {args.pose!r} is rocky-demo-only; "
                             "gas_giant poses: limb, exterior, interior, space")
        camera_of = gas_giant_camera
    else:
        scene = build_demo_scene(variant=args.variant, procedural=not args.textures,
                                 shape_basis=args.shape_basis, device=device)
    if args.panorama:
        from .utils.color import srgb_to_linear
        from .utils.image_io import read_image_rgb

        img8 = read_image_rgb(args.panorama)
        scene.opaque = dataclasses.replace(
            scene.opaque, panorama=srgb_to_linear(img8.astype(np.float32) / 255.0,
                                                  device=device))
    cam = camera_of(args.pose, device=device)
    width = args.size if args.width is None else args.width
    scene.update(args.time, cam)
    t0 = time.perf_counter()
    img = scene.render(cam, args.size, width, renderer=args.renderer)["color"]
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    dt = time.perf_counter() - t0
    if args.glow:
        from .render.glow import GlowSettings, apply_glow

        img = apply_glow(img, scene.environment or GlowSettings.demo())
    _png(args.output, img)
    print(f"wrote {args.output} ({img.shape[1]}x{img.shape[0]}) in {dt:.2f}s "
          f"(includes the kernel build on first run)")
    if args.stats:
        from .utils.profiling import FrameTimer

        atmo_cfg = scene.atmospheres[0].config if scene.atmospheres else None
        timer = FrameTimer(img.shape[0], img.shape[1], atmo_cfg, device=img.device)
        for i in range(args.stats):
            scene.update(args.time + 0.016 * (i + 1), cam)
            with timer.frame():
                scene.render(cam, img.shape[0], img.shape[1], renderer=args.renderer)
        stats = timer.stats().as_dict()
        # per-frame latency: each frame's time runs to the end of its device work
        stats["includes_device_sync"] = True
        print(json.dumps(stats))


def cmd_bake_lut(args) -> None:
    from .ops.optical_depth import bake_optical_depth

    lut = bake_optical_depth(args.radius, args.height, args.density,
                             resolution=args.resolution, device=args.device).cpu().numpy()
    np.save(args.output, lut)
    print(f"wrote {args.output}: {lut.shape} f32, max OD {lut.max():.3f}")


def cmd_export_cubemap(args) -> None:
    from .models.demo import COVERAGE_NOISE, COVERAGE_SCALE
    from .models.noise_cubemap import NoiseCubemap

    cm = NoiseCubemap(noise=COVERAGE_NOISE, resolution=args.resolution, scale=COVERAGE_SCALE,
                      device=args.device)
    sidecar = cm.save_as_image(args.output)
    print(f"wrote {args.output} (3x2 atlas, {args.resolution}px faces) + {sidecar}")


def cmd_fly(args) -> None:
    """Render a camera flight path through the demo scene (the avatar's)."""
    from .models.demo import build_demo_scene
    from .utils.flight import approach_path, orbit_path

    device = args.device
    scene = build_demo_scene(variant=args.variant, procedural=True, device=device)
    if args.path == "orbit":
        cams = orbit_path(radius=300.0, height=80.0, frames=args.frames, device=device)
    else:
        cams = approach_path((0.0, 40.0, 420.0), (0.0, 104.5, 30.0), frames=args.frames,
                             device=device)
    cams = list(cams)
    t0 = time.perf_counter()
    if args.taa:
        # the temporally accumulated flight: every frame's launches back to
        # back, each resolved against the previous one (the resolve tiles
        # the frame in 128 columns and refuses other sides, as JAX's does)
        stack = np.stack([c.view_to_world.cpu().numpy() for c in cams])
        times = [i / 60.0 for i in range(len(cams))]
        colors = scene.render_flight(cams[0], times, args.size, args.size,
                                     cam_transforms=stack, taa_blend=args.taa_blend,
                                     taa_clamp=args.taa_clamp,
                                     taa_depth_eps=args.taa_depth_eps)["color"]
        for i in range(colors.shape[0]):
            _png(f"{args.output_prefix}{i:04d}.png", colors[i])
    else:
        for i, cam in enumerate(cams):
            scene.update(i / 60.0, cam)
            _png(f"{args.output_prefix}{i:04d}.png",
                 scene.render(cam, args.size, args.size)["color"])
    dt = time.perf_counter() - t0
    print(f"rendered {args.frames} frames to {args.output_prefix}NNNN.png in {dt:.1f}s")


def cmd_fit(args) -> None:
    """Inverse rendering: recover atmosphere params from a target frame."""
    from .models.demo import build_demo_scene, demo_camera
    from .models.inverse import fit
    from .ops.kernels.megakernel import render_scene_plain

    device = args.device
    # ground-truth scene with perturbed parameters as the "unknown"; the
    # target is the plain frame, the one the fit differentiates
    scene = build_demo_scene(variant=args.variant, procedural=True, device=device)
    cam = demo_camera(args.pose, device=device)
    scene.update(0.0, cam)
    atmo = scene.atmospheres[0]
    true_params = atmo.build_params().resolve_frame_state()
    with torch.no_grad():
        target = render_scene_plain((true_params,), (atmo.config,), cam, scene.opaque,
                                    args.size, args.size)["color"]

    # start from the shader defaults and descend
    start = dataclasses.replace(
        true_params, density=torch.tensor(0.2, device=device),
        scattering_strength=torch.tensor(0.5, device=device))
    fitted, losses = fit(start, atmo.config, cam, scene.opaque, target, args.size, args.size,
                         steps=args.steps, lr=args.lr)
    print(f"loss {losses[0]:.6f} -> {losses[-1]:.6f} over {args.steps} steps")
    print(f"density: true {float(true_params.density):.4f} "
          f"start 0.2000 fitted {float(fitted.density):.4f}")
    print(f"scattering_strength: true {float(true_params.scattering_strength):.4f} "
          f"start 0.5000 fitted {float(fitted.scattering_strength):.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="godot_atmosphere_shader_tpu_torch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every tensor lives and every frame renders")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a demo-scene frame to PNG")
    r.add_argument("--variant", default="clouds",
                   choices=["no_clouds", "clouds", "clouds_high", "clouds_high_rm",
                            "v1_no_clouds", "v1_clouds", "v1_clouds_high", "gas_giant"])
    r.add_argument("--pose", default="space",
                   choices=["avatar", "exterior", "interior", "space", "sunrise", "sunward",
                            "limb"])
    r.add_argument("--size", type=int, default=512)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--time", type=float, default=0.0)
    r.add_argument("--shape-basis", default="value", choices=["value", "cellular"],
                   help="in-march cloud shape basis: fast value fractal or 8-cell Worley "
                        "cellular (closer to the baked reference, ~2x march cost)")
    r.add_argument("--textures", action="store_true",
                   help="use baked textures instead of procedural fields")
    r.add_argument("--renderer", default="auto", choices=["auto", "kernel", "plain"])
    r.add_argument("--glow", action="store_true",
                   help="apply the Environment glow/bloom output stage (the scene's "
                        "settings, or the demo env defaults)")
    r.add_argument("--panorama", default=None, metavar="IMAGE",
                   help="equirect sky image (PNG; other formats through PIL where "
                        "installed) replacing the procedural starfield")
    r.add_argument("--scene", default=None,
                   help="import a Godot .tscn scene file instead of the built-in demo")
    r.add_argument("--stats", type=int, default=0, metavar="N",
                   help="after writing the frame, time N more frames and print "
                        "per-frame stats JSON")
    r.add_argument("-o", "--output", default="frame.png")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bake-lut", help="bake the optical-depth LUT to .npy")
    b.add_argument("--radius", type=float, default=100.0)
    b.add_argument("--height", type=float, default=8.0)
    b.add_argument("--density", type=float, default=0.5)
    b.add_argument("--resolution", type=int, default=256)
    b.add_argument("-o", "--output", default="optical_depth.npy")
    b.set_defaults(fn=cmd_bake_lut)

    e = sub.add_parser("export-cubemap",
                       help="bake the coverage NoiseCubemap to an importable PNG")
    e.add_argument("--resolution", type=int, default=256)
    e.add_argument("-o", "--output", default="noise_cubemap.png")
    e.set_defaults(fn=cmd_export_cubemap)

    f = sub.add_parser("fly", help="render a camera flight path (demo avatar)")
    f.add_argument("--variant", default="clouds")
    f.add_argument("--path", default="approach", choices=["orbit", "approach"])
    f.add_argument("--frames", type=int, default=8)
    f.add_argument("--size", type=int, default=256)
    f.add_argument("-o", "--output-prefix", default="flight_")
    f.add_argument("--taa", action="store_true",
                   help="temporal accumulation (reprojected history blend)")
    f.add_argument("--taa-blend", type=float, default=0.15,
                   help="current-frame weight of the TAA blend")
    f.add_argument("--taa-clamp", default="minmax", choices=["minmax", "variance"],
                   help="history clamp: 3x3 min/max box or variance clipping")
    f.add_argument("--taa-depth-eps", type=float, default=0.2,
                   help="relative depth-mismatch tolerance of the disocclusion check")
    f.set_defaults(fn=cmd_fly)

    t = sub.add_parser("fit", help="inverse rendering: fit params to a target")
    t.add_argument("--variant", default="no_clouds")
    t.add_argument("--pose", default="exterior")
    t.add_argument("--size", type=int, default=128)
    t.add_argument("--steps", type=int, default=60)
    t.add_argument("--lr", type=float, default=0.05)
    t.set_defaults(fn=cmd_fit)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
