"""Flight mode: the port's ``Scene.render_flight`` against the JAX flight.

Both packages build the demo scene their own way and render a short flight
on the CPU along the same seeded camera path (the port: its plain version;
JAX: interpret mode or its XLA path).  Tolerances: atol 1e-5 with rtol 1e-4
without clouds (``tests/test_pallas.py``'s bound between the TPU kernel and
XLA: grazing limb rays amplify contraction differences), the cloud
tolerance with clouds (p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤ 1e-4, at most 0.1 % of
pixels above 1e-2: knife-edge noise cells flip on ulp-level differences).
Also: the flight helpers (``utils/flight.py``), the temporal jitter, the
plain frame's depth output, the port's own blue-noise asset, its card
defaults, and that no module of the port imports JAX or the JAX package.
"""

import ast
import dataclasses
import inspect
import os
import pkgutil
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.ops.pallas.taa import taa_resolve as jax_taa_resolve
from godot_atmosphere_shader_tpu.render.opaque import render_opaque as jax_render_opaque
from godot_atmosphere_shader_tpu.render.renderer import render_frame as jax_render_frame
from godot_atmosphere_shader_tpu.utils import flight as jflight
import godot_atmosphere_shader_tpu_torch as port
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import scene as tscene
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh
from godot_atmosphere_shader_tpu_torch.render import jitter as tjitter
from godot_atmosphere_shader_tpu_torch.render.opaque import render_opaque
from godot_atmosphere_shader_tpu_torch.render.renderer import render_frame
from godot_atmosphere_shader_tpu_torch.utils import flight as tflight

torch.set_num_threads(2)

H, W = 64, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = [0.5, 0.5 + 1 / 60, 0.5 + 2 / 60]


def _fly_path(pose, frames=3, yaw=0.004, speed=60.0):
    """Host (K, 4, 4) float32 transforms: a FlyCamera from a demo pose,
    forward with a small yaw per frame (the JAX helper)."""
    eye, target = tdemo._POSES[pose]
    fwd = np.subtract(target, eye) / np.linalg.norm(np.subtract(target, eye))
    fly = jflight.FlyCamera(position=eye, yaw=np.arctan2(-fwd[0], -fwd[2]),
                            pitch=np.arcsin(fwd[1]), speed=speed)
    stack = []
    for _ in range(frames):
        stack.append(np.asarray(fly.camera().view_to_world, np.float32))
        fly.look(yaw, 0.0).move((0.0, 0.0, -1.0))
    return np.stack(stack)


def _image(color, alpha):
    return np.concatenate([np.asarray(color), np.asarray(alpha)[..., None]], axis=-1)


def _cloud_ok(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


def _port_flight(variant, pose, stack, **kw):
    scene = tdemo.build_demo_scene(variant, device="cpu")
    cam = tdemo.demo_camera(pose, device="cpu")
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, TIMES, H, W, cam_transforms=stack, **kw)
    assert mk.counters.plain_calls == len(TIMES) and mk.counters.megakernel_launches == 0
    if "taa_blend" in kw:
        assert taa.counters.plain_calls == len(TIMES) and taa.counters.launches == 0
    assert out["color"].shape == (len(TIMES), H, W, 3) and out["alpha"].shape == (len(TIMES), H, W)
    return _image(out["color"].numpy(), out["alpha"].numpy())


# -- the flight helpers -------------------------------------------------------------


def test_fly_camera_matches_jax():
    j = jflight.FlyCamera(position=(1.0, 2.0, 3.0), yaw=0.3, pitch=-0.2, speed=7.0)
    t = tflight.FlyCamera(position=(1.0, 2.0, 3.0), yaw=0.3, pitch=-0.2, speed=7.0)
    for step in range(5):
        j.look(0.1, 0.5 * step).move((1.0, 0.5, -1.0), dt=0.05, speed_boost=2.0)
        t.look(0.1, 0.5 * step).move((1.0, 0.5, -1.0), dt=0.05, speed_boost=2.0)
        np.testing.assert_allclose(t.basis(), j.basis(), rtol=0, atol=1e-12)
        got = t.camera(device="cpu")
        ref = j.camera()
        np.testing.assert_allclose(got.view_to_world.numpy(), np.asarray(ref.view_to_world),
                                   rtol=0, atol=1e-6)
        assert float(got.fov_y_rad) == float(ref.fov_y_rad)
    assert t.pitch == j.pitch == np.pi / 2  # the pitch clamp


@pytest.mark.parametrize("path", ["orbit", "approach"])
def test_paths_match_jax(path):
    if path == "orbit":
        got = tflight.orbit_path(300.0, 40.0, 5, device="cpu")
        ref = jflight.orbit_path(300.0, 40.0, 5)
    else:
        got = tflight.approach_path((0.0, 150.0, 420.0), (0.0, 104.0, 0.0), 5, device="cpu")
        ref = jflight.approach_path((0.0, 150.0, 420.0), (0.0, 104.0, 0.0), 5)
    pairs = list(zip(got, ref))
    assert len(pairs) == 5
    for g, r in pairs:
        np.testing.assert_allclose(g.view_to_world.numpy(), np.asarray(r.view_to_world),
                                   rtol=0, atol=1e-6)


# -- flights against JAX ------------------------------------------------------------


def test_taa_flight_no_clouds_matches_jax_interpret():
    """The TAA flight end to end against JAX's own (megakernel and TAA
    kernel in interpret mode), from the space pose, where the layer is far
    (the flight renders it fullscreen all the same)."""
    stack = _fly_path("space")
    got = _port_flight("no_clouds", "space", stack, taa_blend=0.2)
    scene = jdemo.build_demo_scene("no_clouds")
    out = scene.render_flight(jdemo.demo_camera("space"), TIMES, H, W, cam_transforms=stack,
                              interpret=True, taa_blend=0.2)
    assert scene.atmospheres[0].mode == tscene.MODE_FAR
    np.testing.assert_allclose(got, _image(out["color"], out["alpha"]), rtol=1e-4, atol=1e-5)


def test_taa_flight_clouds_matches_composed_jax():
    """clouds_high along a fly path from the avatar pose, against a JAX
    reference composed from public functions: per frame the XLA frame with
    temporal jitter, the linear depth of ``render_opaque`` and
    ``taa_resolve`` in interpret mode, with the flight's carry."""
    stack = _fly_path("avatar")
    got = _port_flight("clouds_high", "avatar", stack, taa_blend=0.2)
    scene = jdemo.build_demo_scene("clouds_high")
    atmo = scene.atmospheres[0]
    config = dataclasses.replace(atmo.effective_config(), temporal_jitter=True)
    base = jdemo.demo_camera("avatar")
    history = jnp.zeros((H, W, 3), jnp.float32)
    history_depth = jnp.full((H, W), 1e7, jnp.float32)
    prev = None
    for i, t in enumerate(np.asarray(TIMES, np.float32)):
        atmo.update(float(t), cam_near=0.1, cam_pos=stack[i, :3, 3].astype(np.float64))
        cam = dataclasses.replace(base, view_to_world=jnp.asarray(stack[i]))
        frame = jax_render_frame((atmo.build_params(),), (config,), cam, scene.opaque, H, W)
        ld = jax_render_opaque(scene.opaque, cam, H, W)[2]
        history, history_depth = jax_taa_resolve(
            frame["color"], ld, history, cam if prev is None else prev, cam,
            1.0 if i == 0 else 0.2, H, W,
            interpret=True, history_depth=history_depth)
        prev = cam
        assert _cloud_ok(got[i], _image(history, frame["alpha"])), i


def test_flight_matches_jax_xla_flight():
    stack = _fly_path("avatar")
    got = _port_flight("no_clouds", "avatar", stack)
    scene = jdemo.build_demo_scene("no_clouds")
    out = scene.render_flight(jdemo.demo_camera("avatar"), TIMES, H, W, cam_transforms=stack,
                              renderer="xla")
    np.testing.assert_allclose(got, _image(out["color"], out["alpha"]), rtol=1e-4, atol=1e-5)


def test_temporal_offset_matches_jax():
    """frac(time · 38.196601125), in float32 as the JAX kernel computes it."""
    for t in (0.0, 0.5, 1 / 60, 7.3, 1234.5678):
        toff = jnp.float32(t) * 38.196601125
        assert tjitter.temporal_offset(t) == float(toff - jnp.floor(toff)), t


# -- the port against itself --------------------------------------------------------


def test_texture_flight_equals_per_frame_render():
    """The non-TAA texture flight is Scene.render frame by frame (small
    seeded textures: the point is the flight's bookkeeping)."""
    rng = np.random.default_rng(11)
    textures = (torch.from_numpy(rng.random((16, 16, 16), np.float32)),
                torch.from_numpy(rng.random((6, 32, 32), np.float32)))
    stack = _fly_path("interior", yaw=0.01, speed=120.0)
    flight_scene = tdemo.build_demo_scene("clouds_high", procedural=False, device="cpu",
                                          textures=textures)
    cam = tdemo.demo_camera("interior", device="cpu")
    flight_scene.update(0.0, cam)  # engages the interior LOD before the flight
    flight = flight_scene.render_flight(cam, TIMES, H, W, cam_transforms=stack)
    scene = tdemo.build_demo_scene("clouds_high", procedural=False, device="cpu",
                                   textures=textures)
    scene.update(0.0, cam)
    for i, t in enumerate(np.asarray(TIMES, np.float32)):
        cam_i = dataclasses.replace(cam, view_to_world=torch.from_numpy(stack[i]))
        scene.update(float(t), cam_i)
        assert scene.atmospheres[0].effective_config().cloud_lod == 4
        frame = scene.render(cam_i, H, W)
        assert torch.equal(flight["color"][i], frame["color"]), i
        assert torch.equal(flight["alpha"][i], frame["alpha"]), i
    np.testing.assert_array_equal(flight_scene.atmospheres[0]._params.frame_state.numpy(),
                                  scene.atmospheres[0]._params.frame_state.numpy())


def test_plain_depth_output_is_the_opaque_pass():
    """``linear_depth`` is the opaque pass's, before the sphere-depth blend
    that the atmosphere applies (a nonzero factor tells the two apart)."""
    scene = tdemo.build_demo_scene("clouds", device="cpu")
    atmo = scene.atmospheres[0]
    atmo.set_shader_parameter("u_sphere_depth_factor", 0.5)
    cam = tdemo.demo_camera("exterior", device="cpu")
    scene.update(0.5, cam)
    out = render_frame(atmo.build_params(), atmo.effective_config(), cam, scene.opaque, H, W)
    ref = render_opaque(scene.opaque, cam, H, W)[2]
    assert torch.equal(out["linear_depth"], ref)
    assert bool((ref == 1e7).any()) and bool((ref < 1e7).any())


def test_render_flight_refusals():
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    cam = tdemo.demo_camera("avatar", device="cpu")
    with pytest.raises(ValueError):  # a mesh shards the TAA flight only (as JAX)
        scene.render_flight(cam, TIMES, 64, 128, mesh=make_mesh(2))
    with pytest.raises(ValueError):  # not a mesh
        scene.render_flight(cam, TIMES, 64, 128, taa_blend=0.2, mesh=object())
    far = tdemo.Camera.create(tdemo.look_at((0.0, 0.0, 5.0e4), (0.0, 0.0, 0.0), device="cpu"),
                              device="cpu")
    # a far camera is no longer refused: the flight rebases on its position
    out = scene.render_flight(far, TIMES, 8, 128)
    np.testing.assert_array_equal(scene._rebase_origin, [0.0, 0.0, 5.0e4])
    assert torch.isfinite(out["color"]).all()
    with pytest.raises(ValueError):  # the resolve's tiling: rows % 8
        scene.render_flight(cam, TIMES, 12, 128, taa_blend=0.2)
    with pytest.raises(ValueError):
        scene.render_flight(cam, TIMES, 8, 128, taa_blend=0.2, taa_clamp="bogus")


# -- the port stands alone and defaults to the card ---------------------------------


def test_blue_noise_asset_is_the_ports_own_copy():
    theirs = os.path.join(ROOT, "godot_atmosphere_shader_tpu", "assets", "blue_noise_256.npy")
    assert os.path.samefile(os.path.dirname(tjitter.BLUE_NOISE_PATH),
                            os.path.join(os.path.dirname(port.__file__), "assets"))
    with open(tjitter.BLUE_NOISE_PATH, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def _names_jax(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or (
        name.split(".")[0] == "godot_atmosphere_shader_tpu")


def _faults(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = {id(n) for n in _docstring_nodes(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (f"import {a.name}" for a in node.names if _names_jax(a.name))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _names_jax(node.module):
            yield f"from {node.module} import"
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs
              and "godot_atmosphere_shader_tpu" in node.value.replace(
                  "godot_atmosphere_shader_tpu_torch", "")):
            yield f"string {node.value!r}"


def test_port_modules_name_neither_jax_nor_the_jax_package():
    """No ``import jax`` and no import, path or string naming the JAX package
    in any module of the port, its command-line tools (``tools/``) among
    them; ``chip_smoke.py`` and ``compare_megakernel.py`` import neither
    (their kernel lines name the TPU kernels they replace, as data), and no
    line of any of these files starts an import of either, at any indent."""
    paths = [os.path.join(os.path.dirname(port.__file__), "__init__.py")]
    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        paths.append(inspect.getfile(__import__(mod.name, fromlist=["_"])))
    assert len(paths) >= 25
    tools = os.path.join(os.path.dirname(port.__file__), "tools")
    assert {os.path.basename(p) for p in paths if os.path.dirname(p) == tools} == {
        "__init__.py", "gpu_checks.py", "measure_band_fidelity.py"}
    faults = {p: list(_faults(p)) for p in paths}
    assert not any(faults.values()), {p: f for p, f in faults.items() if f}
    scripts = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "compare_megakernel.py")]
    for path in scripts:
        with open(path) as f:
            tree = ast.parse(f.read())
        imports = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        imports += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in imports if _names_jax(m)], path
    line = re.compile(r"^\s*(import|from) (jax|godot_atmosphere_shader_tpu)\b")
    for path in paths + scripts:
        with open(path) as f:
            assert not [t for t in f if line.match(t)], path


@pytest.mark.parametrize("fn", [tdemo.build_demo_scene, tdemo.demo_camera,
                                tdemo.bake_demo_textures, tscene.Scene,
                                tscene.PlanetAtmosphere, tflight.FlyCamera.camera,
                                tflight.orbit_path, tflight.approach_path,
                                port.look_at, port.Camera.create, port.load_tscn,
                                port.load_scene, port.NoiseCubemap, port.default_node_scene,
                                port.bake_optical_depth, port.OpaqueScene.create])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_the_card(monkeypatch):
    from godot_atmosphere_shader_tpu_torch import cli

    seen = {}
    monkeypatch.setattr(cli, "cmd_bake_lut", lambda args: seen.update(device=args.device))
    assert cli.main(["bake-lut"]) == 0 and seen["device"] == "cuda"
