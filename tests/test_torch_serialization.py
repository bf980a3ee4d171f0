"""Scene JSON: the port's ``save_scene``/``load_scene`` round trip, and a
file written by either package loading in the other.

The demo scene (one atmosphere with clouds, its sun, three spheres and a
box) and a two-layer scene; every node property, config field, shader
parameter and opaque array must survive (parameters within 1e-6: colors go
through sRGB).
"""

import dataclasses

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models import serialization as jser
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import scene as tscene
from godot_atmosphere_shader_tpu_torch.models import serialization as tser


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same(a, b):
    """Two scenes (of either package) hold the same nodes and arrays."""
    assert len(a.atmospheres) == len(b.atmospheres)
    for x, y in zip(a.atmospheres, b.atmospheres):
        assert dataclasses.asdict(x.config) == dataclasses.asdict(y.config)
        for name in ("planet_radius", "atmosphere_height", "clouds_rotation_speed",
                     "force_fullscreen"):
            assert getattr(x, name) == pytest.approx(getattr(y, name), rel=1e-7), name
        # the loaders read transforms as float32, as JAX's does
        np.testing.assert_allclose(np.asarray(x.transform), np.asarray(y.transform), rtol=1e-7)
        assert (x.sun is None) == (y.sun is None)
        if x.sun is not None:
            np.testing.assert_array_equal(np.asarray(x.sun.position), np.asarray(y.sun.position))
        for uname in tscene._UNIFORM_TO_FIELD:
            if uname in tscene._API_SHADER_PARAMS or "texture" in uname or "cubemap" in uname:
                continue
            np.testing.assert_allclose(_host(x.get_shader_parameter(uname)),
                                       _host(y.get_shader_parameter(uname)), rtol=1e-6,
                                       atol=1e-6, err_msg=uname)
    for name in tser._OPAQUE_FIELDS:
        np.testing.assert_array_equal(_host(getattr(a.opaque, name)),
                                      _host(getattr(b.opaque, name)), err_msg=name)


def _port_scene():
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    moon = tscene.PlanetAtmosphere(planet_radius=10.0, atmosphere_height=2.0,
                                   position=(-188.991, 0.0, 192.584), custom_shader="v1_clouds",
                                   device="cpu")
    moon.set_shader_parameter("u_day_color0", (0.3, 0.5, 0.9))
    scene.atmospheres.append(moon)
    return scene


def test_round_trip(tmp_path):
    scene = _port_scene()
    path = str(tmp_path / "scene.json")
    tser.save_scene(scene, path)
    back = tser.load_scene(path, device="cpu")
    assert back.device.type == "cpu" and back.opaque.sphere_centers.device.type == "cpu"
    _same(scene, back)
    # a loaded scene saves to a file that loads to itself, byte for byte
    tser.save_scene(back, str(tmp_path / "again.json"))
    tser.save_scene(tser.load_scene(str(tmp_path / "again.json"), device="cpu"),
                    str(tmp_path / "third.json"))
    assert open(tmp_path / "again.json").read() == open(tmp_path / "third.json").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_load(tmp_path, writer):
    """A JAX file loads in the port and a port file in JAX, each equal to
    the scene the other package wrote; both packages' files are the same
    JSON document (numbers within float32 rounding)."""
    jscene = jdemo.build_demo_scene("clouds_high")
    tscene_ = tdemo.build_demo_scene("clouds_high", device="cpu")
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jser.save_scene(jscene, jpath)
    tser.save_scene(tscene_, tpath)
    if writer == "jax":
        _same(tser.load_scene(jpath, device="cpu"), jscene)
    else:
        _same(jser.load_scene(tpath), tscene_)
    import json

    jd, td = json.load(open(jpath)), json.load(open(tpath))
    assert jd.keys() == td.keys()
    assert jd["atmospheres"][0]["custom_shader"] == td["atmospheres"][0]["custom_shader"]
    assert jd["atmospheres"][0]["shader_params"].keys() == td["atmospheres"][0][
        "shader_params"].keys()
    for k in jd["opaque"]:
        np.testing.assert_allclose(np.asarray(td["opaque"][k]), np.asarray(jd["opaque"][k]),
                                   rtol=1e-6, err_msg=k)
