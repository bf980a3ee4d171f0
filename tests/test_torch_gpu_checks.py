"""Port vs JAX: the GPU gate (``godot_atmosphere_shader_tpu_torch/tools/
gpu_checks.py``) against ``tools/tpu_checks.py``, on the CPU.

* The verdict logic on planted frames: one value at 5e-3 fails ``ATOL_MAX``,
  a p99.9 of 2e-3 fails ``ATOL``, alpha above 1 fails; where one ulp of the
  camera itself breaks the gate's bound, the verdict takes the tolerance
  that move keeps and names it.
* The block signature equals the JAX gate's ``_block_signature``.
* The banded sampler: the JAX check runs here with its ``pl.pallas_call``
  in interpret mode; the port's inputs equal the ones it builds (seed 7),
  and the port's plain run equals its samples at 2e-6 and engages.
* On the CPU the checks take the plain versions (a variant, the sharded
  band), and ``main`` exits 2 without a card.  The card's cases are in
  ``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as tts
from godot_atmosphere_shader_tpu_torch.tools import gpu_checks as gc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_gate():
    spec = importlib.util.spec_from_file_location("jax_tpu_checks",
                                                  os.path.join(ROOT, "tools", "tpu_checks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(seed=0, h=64, w=128):
    """A seeded (H, W, 4) reference frame (alpha in [0, 0.99]) and a copy
    within 1e-5 of it."""
    rng = np.random.default_rng(seed)
    ref = rng.random((h, w, 4)).astype(np.float32) * np.float32(0.99)
    got = ref + (rng.random((h, w, 4)).astype(np.float32) - 0.5) * np.float32(2e-5)
    return got.clip(0.0, 1.0), ref


def test_verdict_passes_a_frame_within_the_gate():
    got, ref = _frames()
    r = gc.variant_verdict(got, ref)
    assert r["pass"] and r["tolerance"] == "gate"
    assert r["max_color_diff"] <= 2e-5 and r["p999_alpha_diff"] <= 2e-5


def _one_value(got, channel):
    got[7, 9, channel] += np.float32(5e-3)


def _p999(got, channel):
    """0.25 % of the color (or alpha) values 2e-3 off: their p99.9 is 2e-3."""
    vals = got[..., :3] if channel < 3 else got[..., 3:]
    flat = vals.reshape(-1, vals.shape[-1])
    flat[::400] += np.float32(2e-3)
    vals[...] = flat.reshape(vals.shape)


def _alpha_above_one(got, channel):
    got[3, 4, 3] = np.float32(1.01)


@pytest.mark.parametrize("plant,channel,failing", [
    (_one_value, 0, "max_color_diff"), (_one_value, 3, "max_alpha_diff"),
    (_p999, 1, "p999_color_diff"), (_p999, 3, "p999_alpha_diff"),
    (_alpha_above_one, 3, "alpha_in_range")])
def test_verdict_fails_a_planted_fault(plant, channel, failing):
    got, ref = _frames(1)
    plant(got, channel)
    r = gc.variant_verdict(got, ref)
    assert not r["pass"] and r["tolerance"] == "gate"
    if failing == "alpha_in_range":
        assert not r["alpha_in_range"]
    else:
        bound = gc.ATOL_MAX if failing.startswith("max") else gc.ATOL
        assert r[failing] > bound
        others = [k for k in ("max_color_diff", "max_alpha_diff", "p999_color_diff",
                              "p999_alpha_diff") if k != failing and k[:4] == failing[:4]]
        assert all(r[k] <= bound for k in others)


def _ulp(got, ref):
    return {**gc.gate_deltas(got, ref), **{k: v for k, v in gc.cloud_deltas(got, ref).items()
                                             if k != "worst_pixel"}}


def test_verdict_takes_the_tolerance_one_ulp_keeps():
    """One value at 5e-3: where one ulp of the camera moves the plain frame
    by as much (a knife-edge pixel), the cloud tolerance holds and the
    verdict names it; where that move keeps the gate's bound, it fails."""
    got, ref = _frames(2)
    _one_value(got, 2)
    moved = ref.copy()
    moved[20, 30, 0] += np.float32(6e-3)
    r = gc.variant_verdict(got, ref, _ulp(moved, ref))
    assert r["pass"] and r["tolerance"] == "cloud" and r["cloud"]["max"] > gc.ATOL_MAX
    r = gc.variant_verdict(got, ref, _ulp(ref + np.float32(1e-5), ref))
    assert not r["pass"] and r["tolerance"] == "gate"
    # a move beyond the cloud tolerance: each statistic at twice the move
    moved = ref.copy()
    moved[::10, ::10, 0] += np.float32(0.05)
    ulp = _ulp(moved, ref)
    assert gc.ulp_tolerance_name(ulp) == "conditioned"
    assert gc.variant_verdict(got, ref, ulp)["pass"]


def test_block_signature_equals_the_jax_gate():
    jax_gate = _jax_gate()
    img = np.random.default_rng(3).random((64, 256, 3)).astype(np.float32) * 4.0
    for mine, theirs in zip(gc.block_signature(img), jax_gate._block_signature(img)):
        assert mine.dtype == theirs.dtype == np.float16
        np.testing.assert_array_equal(mine, theirs)
    assert (gc.SIG_BLOCK, gc.SIG_MEAN_TOL, gc.SIG_MAX_TOL) == (
        jax_gate.SIG_BLOCK, jax_gate.SIG_MEAN_TOL, jax_gate.SIG_MAX_TOL)
    assert (gc.ATOL, gc.ATOL_MAX, gc.VARIANT_POSES) == (
        jax_gate.ATOL, jax_gate.ATOL_MAX, jax_gate.VARIANT_POSES)
    with pytest.raises(ValueError):
        gc.block_signature(img[:60])


def test_signature_deltas_read_a_committed_signature(tmp_path):
    """A signature written as the JAX gate writes its goldens reads back
    with no delta; a block 0.01 brighter breaks the block-mean bound.  The
    committed goldens are float16 signatures of a 1080×1920 and a 256×384
    frame."""
    assert np.load(gc.SIG_PATH)["mean"].shape == (135, 15, 3)
    assert np.load(gc.ALLON_SIG_PATH)["max"].shape == (32, 3, 3)
    img = np.random.default_rng(5).random((64, 256, 3)).astype(np.float32)
    mean_sig, max_sig = gc.block_signature(img)
    path = str(tmp_path / "sig.npz")
    np.savez_compressed(path, mean=mean_sig, max=max_sig)
    st = gc.signature_deltas(img, path)
    assert st == {"block_mean_delta": 0.0, "block_max_delta": 0.0} and gc.signature_ok(st)
    img[8:16, 128:256] += np.float32(0.01)
    st = gc.signature_deltas(img, path)
    assert st["block_mean_delta"] > gc.SIG_MEAN_TOL and not gc.signature_ok(st)


def test_banded_sampler_matches_the_jax_check(monkeypatch):
    """The JAX check runs with its ``pallas_call`` in interpret mode; the
    port's inputs are its own, and the port's plain run (banded, then
    windowed) samples as it does at 2e-6, in the same mode and level."""
    calls = []
    real = pl.pallas_call

    def interpret_call(kernel, **kw):
        call = real(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    jax_result = _jax_gate().check_banded_sampler()
    assert jax_result["pass"] and len(calls) == 2
    (data, cx, cy, cz), jax_on = calls[0]
    jax_off = calls[1][1]
    tex, *planes = gc.banded_sampler_inputs()
    np.testing.assert_array_equal(tts.build_tex3d_pyramid(tex)[0], data)
    for mine, theirs in zip(planes, (cx, cy, cz)):
        np.testing.assert_array_equal(mine, theirs)
    s = gc.sample_banded("cpu")
    np.testing.assert_allclose(s["on"].numpy(), jax_on, rtol=0, atol=2e-6)
    np.testing.assert_allclose(s["off"].numpy(), jax_off, rtol=0, atol=2e-6)
    assert s["on_choice"] == (tts.BANDED, 0) and s["off_choice"][0] != tts.BANDED
    r = gc.check_banded_sampler("cpu")
    assert r["pass"] and r["engaged"] and r["launches"] == 0
    assert abs(r["max_abs_diff"] - jax_result["max_abs_diff"]) <= 2e-6


@pytest.mark.parametrize("variant,pose", [("v1_clouds", "avatar"), ("no_clouds", "exterior")])
def test_variant_check_on_the_cpu_takes_the_plain_version(variant, pose):
    r = gc.check_variant(variant, pose, 32, 64, device="cpu")
    assert r["pass"] and r["tolerance"] == "gate" and r["max_color_diff"] == 0.0
    assert r["launches"] == {"k1": 0, "plain": 1, "planned": 1}
    json.dumps(r)


def test_sharded_band_check_on_the_cpu():
    r = gc.check_sharded_band(256, 128, device="cpu")
    assert r["pass"] and r["band_vs_full_max_delta"] == 0.0 and r["n_devices"] == 1
    assert r["local_shards"] == 2 and r["local_vs_full"]["max"] == 0.0


def test_everything_on_scene_is_the_jax_gates():
    """Texture clouds, the check's 32×64 panorama, the far-mode moon, the
    demo glow as its environment."""
    rng = np.random.default_rng(4)
    textures = (torch.from_numpy(rng.random((16, 16, 16)).astype(np.float32)),
                torch.from_numpy(rng.random((6, 16, 16)).astype(np.float32)))
    scene, cam = gc.everything_on_scene("cpu", textures)
    assert [a.config.clouds_enabled for a in scene.atmospheres] == [True, False]
    moon = scene.atmospheres[1]
    assert (moon.planet_radius, moon.atmosphere_height) == (10.0, 2.0)
    np.testing.assert_allclose(moon.position, gc.MOON["position"], rtol=1e-6)
    assert tuple(scene.opaque.panorama.shape) == (32, 64, 3)
    assert scene.environment == dataclasses.replace(gc.GlowSettings.demo())


def test_main_exits_2_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "GPU_CHECKS.json"
    assert gc.main(["-o", str(out)]) == 2
    assert not out.exists() and "needs a CUDA card" in capsys.readouterr().err


def test_one_ulp_of_the_camera_orientation_flips_an_exterior_pixel():
    """The cloud-free exterior frames have a pixel (row 202, column 164 at
    256×384) that one ulp of a rotation entry of the camera moves by 0.06:
    one ulp of its position moves no value beyond 3e-5.  The card's kernel
    lies as far from plain there, so the gate measures the orientation's
    ulps too before it holds a variant to another tolerance."""
    from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera

    scene = build_demo_scene("no_clouds", device="cpu")
    cam = demo_camera("exterior", device="cpu")
    scene.update(0.5, cam)
    moves = gc.transform_ulp_moves(cam)
    assert len(moves) == 2 * int((cam.view_to_world[:3] != 0).sum()) and len(moves) > 6
    base = gc.frame_array(scene.render(cam, 256, 384, renderer="plain"))
    ulp = gc.camera_ulp_move(scene, cam, 256, 384, base)
    assert ulp["max_color_diff"] > gc.ATOL_MAX and not gc.gate_ok(ulp)
    assert gc.ulp_tolerance_name(ulp) == "cloud" and ulp["p999_color_diff"] <= 1e-4
