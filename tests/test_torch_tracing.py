"""The port's spans (``utils/profiling.py::span``) on the CPU: nothing is
entered while no profiler records; under a ``torch.profiler`` session the
host preamble's ranges appear, nested as the calls are; a host tensor's
copy to the host makes no copy span.  The card test
(``tests/test_torch_cuda.py::test_copy_spans_name_every_transfer``) holds
the copy spans against the device's copies."""

import contextlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from godot_atmosphere_shader_tpu_torch import Camera, build_demo_scene
from godot_atmosphere_shader_tpu_torch.models.demo import demo_camera
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
from godot_atmosphere_shader_tpu_torch.utils import profiling

#: substrings the benchmark's readers look for in the trace's device names
READER_NAMES = ("DtoH", "HtoD", "megakernel_gen", "megakernel_clear", "megakernel_tex",
                "tex_choice_kernel", "taa_kernel")
H, W = 8, 128


def _poses(k=2):
    """``k`` view→world transforms of the demo avatar, 0.1 apart along −Z."""
    m = demo_camera("avatar", device="cpu").view_to_world.numpy()
    out = np.repeat(m[None], k, axis=0).copy()
    out[:, :3, 3] -= np.arange(k)[:, None] * 0.1 * m[:3, 2]
    return out


def _frame_and_flight(scene, poses, label=False):
    """A frame (a new camera, ``Scene.update``, ``Scene.render``) and a TAA
    flight of two frames at ``poses``; with ``label``, each call inside the
    ``bench.*`` range the benchmark puts around it."""
    labelled = record_function if label else (lambda name: contextlib.nullcontext())
    with labelled("bench.update"):
        cam = Camera.create(poses[0], device="cpu")
        scene.update(0.5, cam)
    with labelled("bench.render"):
        scene.render(cam, H, W)
    with labelled("bench.render_flight"):
        cam = Camera.create(poses[0], device="cpu")
        scene.render_flight(cam, [0.5, 0.5 + 1 / 60], H, W, cam_transforms=poses,
                            taa_blend=0.15)


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range was entered with no profiler recording")


def _ranges(prof):
    """The trace's ``port.*`` and ``bench.*`` CPU events."""
    return [e for e in prof.events() if e.name.startswith(("port.", "bench."))]


def _parent(e):
    return e.cpu_parent.name if e.cpu_parent is not None else None


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("port.scene.render") is profiling._OFF
    assert profiling.span("port.copy.cam_host", "cuda") is profiling._OFF


def test_span_opens_a_range_only_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("port.scene.render")
        assert on is not profiling._OFF
        assert type(on).__name__ == "RecordFunctionFast"
        # a copy span opens only for a card: a host tensor's copy copies nothing
        assert profiling.span("port.copy.cam_host", "cpu") is profiling._OFF
        assert profiling.span("port.copy.cam_host", torch.device("cpu")) is profiling._OFF
        assert profiling.span("port.copy.cam_host", "cuda") is not profiling._OFF
        assert profiling.span("port.copy.cam_host", torch.device("cuda", 0)) is not \
            profiling._OFF
        with profiling.span("port.scene.render"):
            pass
    assert profiling.span("port.scene.render") is profiling._OFF


def test_no_profiler_no_range_entered(monkeypatch):
    """A CPU frame and flight of the demo scene, and the launch structs
    computed directly, enter no profiler range while none records."""
    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    scene = build_demo_scene("clouds_high", device="cpu")
    poses = _poses()
    _frame_and_flight(scene, poses)
    cam = Camera.create(poses[0], device="cpu")
    _, params, configs = scene._sorted_layers(cam)
    mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W)
    taa.flight_constants(cam, poses, taa.TaaSettings(), H, W)


def test_spans_nest_as_the_calls_do():
    scene = build_demo_scene("no_clouds", device="cpu")
    poses = _poses()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame_and_flight(scene, poses, label=True)
    events = _ranges(prof)
    names = [e.name for e in events]
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(_parent(e))
    n_atmo = len(scene.atmospheres)
    assert names.count("port.camera.create") == 2
    assert parents["port.camera.create"] == {"bench.update", "bench.render_flight"}
    assert parents["port.scene.update"] == {"bench.update"}
    assert names.count("port.scene.atmosphere_update") == n_atmo
    assert parents["port.scene.atmosphere_update"] == {"port.scene.update"}
    assert parents["port.scene.render"] == {"bench.render"}
    assert parents["port.scene.render_flight"] == {"bench.render_flight"}
    for name in ("port.scene.sorted_layers", "port.scene.kernel_plan"):
        assert parents[name] == {"port.scene.render", "port.scene.render_flight"}
    assert parents["port.scene.layer_bands"] == {"port.scene.render"}
    assert parents["port.scene.frame_states"] == {"port.scene.render_flight"}
    assert names.count("port.scene.frame_states") == 1
    # the CPU flight renders plainly; its TAA structs are computed on the host
    assert parents["port.taa.flight_constants"] == {"port.scene.render_flight"}
    # every tensor is on the host: no copy span
    assert not [n for n in names if n.startswith("port.copy.")]
    # every program span inside one of the benchmark's
    for e in events:
        if e.name.startswith("port."):
            up = e.cpu_parent
            while up is not None and not up.name.startswith("bench."):
                up = up.cpu_parent
            assert up is not None, e.name
    for name in set(names):
        assert not any(s in name for s in READER_NAMES), name


def test_constants_on_host_tensors_give_their_spans_and_no_copy():
    scene = build_demo_scene("clouds_high", device="cpu")
    poses = _poses(3)
    cam = Camera.create(poses[0], device="cpu")
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    rows = np.stack([scene.atmospheres[0].frame_state_row(0.5 + i / 60, poses[i, :3, 3])
                     for i in range(3)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W)
        mk.flight_constants(params[0], configs[0], cam, scene.opaque, H, W, rows,
                            poses.astype(np.float32))
        taa.flight_constants(cam, poses, taa.TaaSettings(), H, W)
    events = [e for e in prof.events() if e.name.startswith("port.")]
    names = [e.name for e in events]
    assert names.count("port.megakernel.frame_constants") == 2
    assert names.count("port.megakernel.flight_constants") == 1
    assert names.count("port.taa.flight_constants") == 1
    # the flight's first struct is a whole one, computed inside its span
    assert [_parent(e) for e in events if e.name == "port.megakernel.frame_constants"] == [
        None, "port.megakernel.flight_constants"]
    assert not [n for n in names if n.startswith("port.copy.")]
