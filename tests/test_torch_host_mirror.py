"""Host mirrors (``utils/host_mirror.py``) on the CPU: the launch structs of
a fly-through read from the mirrors are byte for byte the ones read by
copies; an edited or new tensor is read anew, never from a stale mirror;
a steady frame makes no copy; and a mirror lives as long as its tensor.

The card test (``tests/test_torch_cuda.py::test_frame_waits_for_no_copy``)
holds the frame to no synchronising copy on the device."""

import gc

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu_torch import Camera, OpaqueScene, build_demo_scene
from godot_atmosphere_shader_tpu_torch.models import scene as tscene
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.utils import host_mirror
from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

#: the benchmark's frame: the launch structs are computed, nothing is rendered
H, W = 1080, 1920
FRAMES = 20


def _fly_loop(frames=FRAMES):
    """``(view_to_world, time)`` of the demo avatar's first ``frames`` frames:
    10 units/s forward, 0.002 rad of yaw a frame, at 60 frames/s."""
    fly = FlyCamera(position=(0.0, 0.0, 156.425))
    out = []
    for i in range(frames):
        out.append((fly.view_to_world().astype(np.float32), 0.5 + i / 60.0))
        fly.look(0.002, 0.0).move((0.0, 0.0, -10.0 / 60.0))
    return out


@pytest.fixture
def kernel_route(monkeypatch):
    """``Scene.render`` on the CPU as it runs on the card up to the launches:
    the arguments of each ``render_scene_megakernel`` call, kept in order."""
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return {}

    monkeypatch.setattr(tscene, "render_scene_megakernel", record)
    return calls


def _structs(call, mirrors=True):
    """The frame's launch structs as bytes, its tensors read from their
    mirrors or (``mirrors=False``) every one by a copy."""
    args, kwargs = call
    with pytest.MonkeyPatch.context() as mp:
        if not mirrors:
            mp.setattr(host_mirror, "_mirror", lambda t: None)
        return [bytes(s) for _, s, _ in mk.scene_launches(*args, **kwargs)]


def _frame(scene, pose, time_s):
    cam = Camera.create(pose, device="cpu")
    scene.update(time_s, cam)
    scene.render(cam, H, W)
    return cam


def test_structs_from_mirrors_equal_the_copy_path(kernel_route):
    scene = build_demo_scene("clouds_high", device="cpu")
    for pose, t in _fly_loop():
        _frame(scene, pose, t)
    assert len(kernel_route) == FRAMES
    live = [_structs(c) for c in kernel_route]
    copied = [_structs(c, mirrors=False) for c in kernel_route]
    assert live == copied
    assert all(len(s) == 1 for s in live) and len({s[0] for s in live}) == FRAMES


def _move_camera(scene, cam):
    with torch.no_grad():
        cam.view_to_world[:3, 3] += torch.tensor([0.5, -0.25, 1.0])


def _scale_density(scene, cam):
    with torch.no_grad():
        scene.atmospheres[0]._params.density.mul_(2.0)


def _shader_parameter(scene, cam):
    scene.atmospheres[0].set_shader_parameter("u_cloud_density_scale", 3.0)


def _color_parameter(scene, cam):
    scene.atmospheres[0].set_shader_parameter("u_atmosphere_modulate", (0.9, 0.8, 0.7))


def _new_opaque(scene, cam):
    scene.opaque = OpaqueScene.create(
        spheres=[((0.0, 0.0, 0.0), 100.0, (0.3, 0.3, 0.3)),
                 ((-150.0, 20.0, 180.0), 12.0, (0.6, 0.6, 0.6))],
        light_dir=(0.0, 0.0, -1.0), ambient=0.03, sky_color=(0.001, 0.001, 0.002),
        star_intensity=1.0, device="cpu")


@pytest.mark.parametrize("edit,copies", [
    (_move_camera, 1),  # in place: the camera's transform is copied once
    (_scale_density, 1),  # in place, as an optimiser step would
    (_shader_parameter, 0),  # a new tensor, uploaded with its mirror
    (_color_parameter, 1),  # a new tensor converted on the device: copied once
    (_new_opaque, 0),  # new tensors, uploaded with their mirrors
])
def test_an_edit_is_read_anew(kernel_route, edit, copies):
    scene = build_demo_scene("clouds_high", device="cpu")
    (pose, t), _ = _fly_loop(2)
    cam = _frame(scene, pose, t)
    before = _structs(kernel_route[-1])
    edit(scene, cam)
    host_mirror.counters.reset()
    scene.update(t, cam)
    scene.render(cam, H, W)
    live = _structs(kernel_route[-1])
    assert host_mirror.counters.copies == copies
    assert live != before
    assert live == _structs(kernel_route[-1], mirrors=False)


def test_a_steady_frame_makes_no_copy(kernel_route, monkeypatch):
    reads = []
    hosts = host_mirror.hosts

    def counted(tensors, site):
        reads.append(len(tensors))
        return hosts(tensors, site)

    monkeypatch.setattr(host_mirror, "hosts", counted)
    scene = build_demo_scene("clouds_high", device="cpu")
    per_frame = []
    for i, (pose, t) in enumerate(_fly_loop()):
        host_mirror.counters.reset()
        reads.clear()
        _frame(scene, pose, t)
        _structs(kernel_route[-1])
        per_frame.append((host_mirror.counters.copies, host_mirror.counters.hits, sum(reads)))
    # the first frame copies what was converted on the device once (the colors)
    assert per_frame[0][0] == 1
    for copies, hits, read in per_frame[1:]:
        assert copies == 0 and hits == read > 0
    assert len({p for p in per_frame[1:]}) == 1


@pytest.mark.parametrize("value,dtype,want", [
    (np.arange(16, dtype=np.float64).reshape(4, 4), torch.float64, torch.float64),
    (np.arange(24, dtype=np.float32), None, torch.float32),
    (0.1, torch.float32, torch.float32),
    (torch.arange(3, dtype=torch.float64), torch.float32, torch.float32),
])
def test_upload_keeps_what_it_uploaded(value, dtype, want):
    t = host_mirror.upload(value, "cpu", dtype)
    host_mirror.counters.reset()
    m = host_mirror.host(t, "port.copy.test")
    assert (host_mirror.counters.hits, host_mirror.counters.copies) == (1, 0)
    assert t.dtype == m.dtype == want and m.shape == t.shape and torch.equal(m, t)
    assert m.data_ptr() != t.data_ptr()
    m.add_(1.0)  # a mirror edited by its reader is not served again
    again = host_mirror.host(t, "port.copy.test")
    assert host_mirror.counters.copies == 1 and torch.equal(again, t)


def test_a_mirror_lives_as_long_as_its_tensor():
    row = np.arange(24, dtype=np.float32)
    t = host_mirror.upload(row, "cpu", None)
    row[:] = -1.0  # the caller's array is not the mirror
    assert torch.equal(host_mirror.host(t, "port.copy.test"), torch.arange(24.0))
    key = id(t)
    assert key in host_mirror._MIRRORS
    del t
    gc.collect()
    assert key not in host_mirror._MIRRORS
