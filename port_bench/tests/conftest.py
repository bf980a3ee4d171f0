"""What the benchmark's CPU tests share: a configuration of the upstream demo's
baked textures (``demo_clouds_high_tex``), added to a copy of the benchmark
as a file alone, as a later configuration would be added."""

import dataclasses
import functools
import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEX = "demo_clouds_high_tex"
#: the CPU tests' bakes: a 16³ shape texture and 32² cube faces (the demo's
#: are 64³ and 256²: a 64³ cellular 8-octave bake takes the CPU a minute)
SHAPE_SIZE, CUBEMAP_SIZE = 16, 32


def tex_config(shape_size: int = SHAPE_SIZE, cubemap_size: int = CUBEMAP_SIZE) -> dict:
    """``demo_clouds_high.json`` on the demo's own asset pipeline: the port's
    scene with ``procedural: false``, no procedural field, and the
    ``textures`` block of ``models/demo.py``'s bakes (``SHAPE_NOISE_BAKE``;
    ``COVERAGE_NOISE`` at ``COVERAGE_SCALE``) at these sizes."""
    from godot_atmosphere_shader_tpu_torch.models import demo

    cfg = json.load(open(os.path.join(ROOT, "port_bench", "configs", "demo_clouds_high.json")))
    cfg["name"] = TEX
    cfg["make_scene"]["args"]["procedural"] = False
    cfg["variant"]["cloud_shape_noise"] = cfg["variant"]["cloud_coverage_noise"] = None
    cfg["assumed"] = []
    cfg["textures"] = {
        "shape": {"noise": dataclasses.asdict(demo.SHAPE_NOISE_BAKE), "size": shape_size},
        "coverage": {"noise": dataclasses.asdict(demo.COVERAGE_NOISE),
                     "scale": list(demo.COVERAGE_SCALE), "size": cubemap_size}}
    return cfg


@pytest.fixture
def small_bake(monkeypatch):
    """The port's demo bake at the CPU tests' sizes."""
    from godot_atmosphere_shader_tpu_torch.models import demo

    monkeypatch.setattr(demo, "bake_demo_textures", functools.partial(
        demo.bake_demo_textures, shape_size=SHAPE_SIZE, cubemap_size=CUBEMAP_SIZE))


@pytest.fixture
def tex_checkout(tmp_path, monkeypatch, small_bake):
    """A checkout whose benchmark has the texture configuration as one more
    file (``port_bench/configs/demo_clouds_high_tex.json``) and its
    ``fly_loop`` cell in ``BENCHMARK.json``, the cell reporting what the
    other ``fly_loop`` cells report; the harness finds configurations
    there.  Returns the checkout's root."""
    from port_bench import harness

    bench = tmp_path / "port_bench"
    shutil.copytree(os.path.join(ROOT, "port_bench"), bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    json.dump(tex_config(), open(bench / "configs" / f"{TEX}.json", "w"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = f"{TEX}.fly_loop"
    manifest["workloads"].append({"name": cell, "config": TEX, "traffic": "fly_loop",
                                  "chips": 1, "why": "the demo's baked textures"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "demo_clouds_high.fly_loop" in m.get("workloads", ()):
            m["workloads"].append(cell)
    json.dump(manifest, open(tmp_path / "BENCHMARK.json", "w"))
    monkeypatch.setattr(harness, "load_config",
                        functools.partial(harness.load_config, base=str(bench)))
    return tmp_path
