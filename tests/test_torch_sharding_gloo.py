"""The distributed mesh on the CPU: two ``torch.distributed`` processes
(gloo, a file rendezvous) each render their shard of a sharded TAA flight,
exchange the history halo rows with point-to-point sends and all-gather
the frames; both ranks' frames equal the local mesh's (one process, both
shards in turn) bit for bit.  Likewise inverse rendering's sharded training
step: each rank differentiates its own rows, then the ranks all-reduce the
loss and the gradients; both ranks' loss and updated knobs equal the local
mesh's bit for bit.

This module imports only the port: the spawned ranks import it to find
their entry point.
"""

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

H, W = 64, 128
TIMES = [0.5, 0.5 + 1 / 60, 0.5 + 2 / 60]
TIMEOUT_S = 240


def _flight(mesh):
    """``clouds_high`` along a short fly path from the avatar pose, 2 shards
    of 32 rows."""
    from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    fly = FlyCamera(position=(0.0, 0.0, 156.425), speed=10.0)
    stack = []
    for _ in TIMES:
        stack.append(fly.view_to_world())
        fly.look(0.004, 0.003).move((0.0, 0.0, -1.0), dt=1 / 60)
    scene = build_demo_scene("clouds_high", device="cpu")
    cam = demo_camera("avatar", device="cpu")
    return scene.render_flight(cam, TIMES, H, W, cam_transforms=np.stack(stack),
                               taa_blend=0.2, mesh=mesh)


def _step(mesh):
    """One training step of the seven knobs on ``clouds``/space (the JAX
    dryrun's config) at 32×128 from the fit's start point, 2 shards of 16
    rows."""
    import dataclasses

    from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera
    from godot_atmosphere_shader_tpu_torch.models.inverse import DEFAULT_TRAINABLE
    from godot_atmosphere_shader_tpu_torch.ops.kernels.megakernel import render_scene_plain
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import train_step_sharded

    scene = build_demo_scene("clouds", device="cpu")
    cam = demo_camera("space", device="cpu")
    scene.update(0.0, cam)
    atmo = scene.atmospheres[0]
    true = atmo.build_params().resolve_frame_state()
    target = render_scene_plain((true,), (atmo.config,), cam, scene.opaque, 32, W)["color"]
    start = dataclasses.replace(true, density=torch.tensor(0.2),
                                scattering_strength=torch.tensor(0.5))
    train = {k: getattr(start, k) for k in DEFAULT_TRAINABLE}
    return train_step_sharded(train, start, atmo.config, cam, scene.opaque, target, 32, W, mesh)


def _rank(rank, rendezvous, out, job):
    """One rank: ``job`` on its distributed mesh, the result to disk."""
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", world_size=2,
                            rank=rank)
    try:
        mesh = make_mesh(group=dist.group.WORLD)
        assert (mesh.size, list(mesh.shards())) == (2, [rank])
        torch.save(job(mesh), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _on_two_ranks(tmp_path, job) -> list:
    """``job(mesh)`` on each of two gloo ranks: their results."""
    out = str(tmp_path / "result")
    ctx = mp.spawn(_rank, args=(str(tmp_path / "rendezvous"), out, job), nprocs=2, join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(f"{out}.{rank}") for rank in range(2)]


def test_gloo_flight_equals_the_local_mesh_bit_for_bit(tmp_path):
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh

    ranks = _on_two_ranks(tmp_path, _flight)
    local = _flight(make_mesh(2))
    assert local["color"].shape == (len(TIMES), H, W, 3)
    for rank, got in enumerate(ranks):
        assert torch.equal(got["color"], local["color"]), rank
        assert torch.equal(got["alpha"], local["alpha"]), rank


def test_gloo_training_step_equals_the_local_mesh_bit_for_bit(tmp_path):
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh

    ranks = _on_two_ranks(tmp_path, _step)
    loss, new = _step(make_mesh(2))
    assert len(new) == 7 and all(torch.isfinite(v).all() for v in new.values())
    for rank, (got_loss, got) in enumerate(ranks):
        assert torch.equal(got_loss, loss), rank
        for k, v in new.items():
            assert torch.equal(got[k], v), (rank, k)
