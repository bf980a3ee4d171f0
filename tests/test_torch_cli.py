"""The command line: ``render --device cpu`` against the JAX CLI's PNG
(within 1/255: one float32 ulp can flip an 8-bit level), ``bake-lut``
against the JAX bake (atol 1e-6 × max) and ``export-cubemap`` against the
JAX export (within 1/255), on the CPU.  The JAX CLI runs in this process
with its XLA path run eagerly (the envelope tests' ``eager_jax``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from godot_atmosphere_shader_tpu import cli as jcli
from godot_atmosphere_shader_tpu_torch import cli as tcli
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.utils.image_io import read_png


@pytest.fixture
def eager_jax(monkeypatch):
    def fori_loop(lower, upper, body, init, **kwargs):
        for i in range(int(lower), int(upper)):
            init = body(jnp.int32(i), init)
        return init

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _png_close(a, b):
    a, b = read_png(a).astype(int), read_png(b).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    return a


def test_render_matches_the_jax_cli(tmp_path, eager_jax, capsys):
    args = ["render", "--size", "32", "--pose", "space"]
    mk.counters.reset()
    assert tcli.main(["--device", "cpu"] + args + ["-o", str(tmp_path / "port.png")]) == 0
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    jcli.main(args + ["-o", str(tmp_path / "jax.png")])
    img = _png_close(str(tmp_path / "port.png"), str(tmp_path / "jax.png"))
    assert img.shape == (32, 32, 3) and img.max() > 0
    out = capsys.readouterr().out
    assert "wrote" in out


def test_render_stats_and_renderer_choice(tmp_path, capsys):
    import json

    path = str(tmp_path / "f.png")
    assert tcli.main(["--device", "cpu", "render", "--variant", "no_clouds", "--size", "16",
                      "--width", "24", "--stats", "2", "--renderer", "plain", "-o", path]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (stats["height"], stats["width"], stats["samples_per_ray"]) == (16, 24, 8)
    assert stats["frame_ms"] > 0 and stats["includes_device_sync"]
    assert read_png(path).shape == (16, 24, 3)
    with pytest.raises(SystemExit):
        tcli.main(["render", "--renderer", "pallas"])
    with pytest.raises(SystemExit):
        tcli.main(["--device", "tpu", "render"])


def test_bake_lut(tmp_path):
    from godot_atmosphere_shader_tpu.ops.optical_depth import bake_optical_depth

    path = str(tmp_path / "lut.npy")
    assert tcli.main(["--device", "cpu", "bake-lut", "--resolution", "64", "-o", path]) == 0
    lut = np.load(path)
    ref = np.asarray(bake_optical_depth(100.0, 8.0, 0.5, resolution=64))
    assert lut.shape == (64, 64) and lut.dtype == np.float32
    np.testing.assert_allclose(lut, ref, rtol=0, atol=1e-6 * float(ref.max()))


def test_export_cubemap(tmp_path):
    port, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert tcli.main(["--device", "cpu", "export-cubemap", "--resolution", "16", "-o",
                      port]) == 0
    jcli.main(["export-cubemap", "--resolution", "16", "-o", ref])
    assert _png_close(port, ref).shape == (32, 48)
    assert os.path.exists(port + ".import")
    assert open(port + ".import").read() == open(ref + ".import").read().replace(
        "jax.png", "port.png")


def test_fly_writes_its_frames(tmp_path):
    """``fly`` writes one PNG per frame; with ``--taa`` the side must be a
    multiple of the resolve's 128 columns, as the JAX CLI's."""
    prefix = str(tmp_path / "f_")
    with pytest.raises(ValueError, match="width % 128"):
        tcli.main(["--device", "cpu", "fly", "--taa", "--frames", "2", "--size", "24", "-o",
                   prefix + "refused_"])
    mk.counters.reset()
    assert tcli.main(["--device", "cpu", "fly", "--taa", "--frames", "2", "--size", "128",
                      "-o", prefix]) == 0
    assert mk.counters.plain_calls == 2
    frames = [read_png(f"{prefix}{i:04d}.png") for i in range(2)]
    assert all(f.shape == (128, 128, 3) for f in frames) and frames[1].max() > 0
    assert tcli.main(["--device", "cpu", "fly", "--frames", "1", "--size", "16", "-o",
                      prefix + "plain_"]) == 0
    assert read_png(f"{prefix}plain_0000.png").shape == (16, 16, 3)


def test_fit_prints_the_jax_cli_lines(capsys):
    """``fit --size 32 --steps 5`` (the JAX defaults otherwise: no_clouds,
    exterior, lr 0.05) prints the JAX CLI's three lines, each number within
    rtol 1e-4 (and one unit of its last printed digit) of JAX's; the fit
    renders one plain frame a step plus the target's and launches no K1."""
    import re

    args = ["fit", "--size", "32", "--steps", "5"]
    mk.counters.reset()
    assert tcli.main(["--device", "cpu"] + args) == 0
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (6, 0)
    port = capsys.readouterr().out.strip().splitlines()
    jcli.main(args)
    ref = capsys.readouterr().out.strip().splitlines()
    number = re.compile(r"\d+\.\d+")
    assert len(port) == len(ref) == 3
    assert [number.sub("#", x) for x in port] == [number.sub("#", x) for x in ref]
    assert port[0].startswith("loss ") and port[0].endswith("over 5 steps")
    for got, want in zip(port, ref):
        for a, b in zip(number.findall(got), number.findall(want)):
            last_digit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b)) + last_digit, (got, want)
    first, last = (float(x) for x in number.findall(port[0])[:2])
    assert last < first


def test_fit_defaults_to_the_card_and_the_jax_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(tcli, "cmd_fit", lambda args: seen.update(vars(args)))
    assert tcli.main(["fit"]) == 0
    assert seen["device"] == "cuda"
    assert {k: seen[k] for k in ("variant", "pose", "size", "steps", "lr")} == dict(
        variant="no_clouds", pose="exterior", size=128, steps=60, lr=0.05)
