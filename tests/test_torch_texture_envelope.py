"""K1's texture envelope (slice (i)) on the CPU: every texture-mode config
the JAX megakernel renders beyond the demo's profile, through the port.

The cases: one baked field beside a procedural one (coverage or shape
procedural, from knots or per step), full quality (the detail knots from
the shape texture), coverage K = 4 and 16, shape knots 8 and 32, LOD groups
of 1, 2, 16 and 32 rows, and (pyramid sampling only: exact sampling has no
batches) knot groups of 1 and 17.  At 64×128 with 8 march steps:

* the port's exact-sampling ``render_frame`` against the JAX package's XLA
  texture path (``renderer="xla"``), run eagerly (``eager_jax``, as in
  ``tests/test_torch_envelope.py``), at the cloud tolerance (p99.9 |Δ| ≤
  1e-3, mean ≤ 1e-4, at most 0.1 % of pixels above 1e-2), full quality
  and coverage groups of 32 rows included (measured: p99.9 7.4e-5 and
  8.6e-6; the procedural envelope's looser tolerances are not needed
  here);
* the port's pyramid frame (``Scene.render``, the kernel's plain version)
  against its exact frame: mean |Δ| < 2e-3, the JAX package's own bound
  (``tests/test_texture_mode.py``); at LOD groups of 16 rows the pyramid
  frame lies 3.1e-3 from the exact one, and the JAX package's own
  pyramid frame (its Pallas kernel in interpret mode) equals the port's
  within 4.6e-5, so there the bound is not the config's: the case is
  held against that JAX frame at the cloud tolerance, as are one mixed
  layer and full quality;
* the mixed layer's plan (metas and tables) against the JAX
  ``Scene._pallas_plan`` (its TPU branch, ``jax.default_backend``
  monkeypatched as in ``tests/test_texture_mode.py``);
* the launch struct's new fields (each field's source) and the general
  instance's layout against the CUDA source.

The textures come from one module fixture, baked once in JAX at 16³ and
6×32² (the demo's specs; the full-size bake is the card's) and carried
across as numpy.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models import params as jparams
from godot_atmosphere_shader_tpu.ops import sampling as jsampling
from godot_atmosphere_shader_tpu.ops.pallas.megakernel import render_scene_pallas
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import params as tparams
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.render.renderer import render_frame

torch.set_num_threads(2)

H, W = 64, 128
STEPS = 8

# case: config changes; "coverage"/"shape" = "procedural" replaces that
# baked field by the demo's procedural one
CASES = {
    "shape_baked_coverage_knots": dict(coverage="procedural"),
    "shape_baked_coverage_per_step": dict(coverage="procedural", cloud_coverage_interp=False),
    "shape_knots_coverage_baked": dict(shape="procedural", cloud_shape_interp=True),
    "shape_per_step_coverage_baked": dict(shape="procedural", cloud_shape_interp=False),
    "full_quality": dict(clouds_always_low_quality=False),
    "coverage_k4": dict(cloud_coverage_knots=4),
    "coverage_k16": dict(cloud_coverage_knots=16),
    "shape_knots_8": dict(cloud_shape_knots=8),
    "shape_knots_32": dict(cloud_shape_knots=32),
    "group_1": dict(cloud_lod=1, cloud_coverage_lod=1, cloud_lod_interior=0),
    "group_2": dict(cloud_lod=1, cloud_coverage_lod=2, cloud_lod_interior=0),
    "group_16": dict(cloud_lod=8, cloud_coverage_lod=2, cloud_lod_interior=0),
    "group_32": dict(cloud_lod=16, cloud_coverage_lod=2, cloud_lod_interior=0),
}
PYRAMID_CASES = {**CASES, "knot_group_1": dict(texture_knot_group=1),
                 "knot_group_17": dict(texture_knot_group=17)}
# held against the JAX package's pyramid frame (its Pallas kernel in
# interpret mode, ~16 s each) instead of the exact frame
PALLAS_CASES = ("group_16", "shape_baked_coverage_knots", "full_quality")

JAX = {"demo": jdemo, "params": jparams}
PORT = {"demo": tdemo, "params": tparams}


@pytest.fixture(scope="module")
def textures():
    """The demo's shape texture (16³) and coverage cubemap (6×32²), baked
    once by the JAX package, as numpy."""
    shape = jsampling.bake_noise_texture3d(jdemo.SHAPE_NOISE_BAKE, 16)
    cubemap = jsampling.bake_noise_cubemap(jdemo.COVERAGE_NOISE, jdemo.COVERAGE_SCALE, 32)
    return np.array(shape, np.float32), np.array(cubemap, np.float32)


@pytest.fixture
def eager_jax(monkeypatch):
    """The JAX package's XLA path run op by op: ``jax.disable_jit`` with a
    ``fori_loop`` that hands its body an int32 index, as the traced loop
    does (the eager one hands a Python int)."""
    def fori_loop(lower, upper, body, init, **kwargs):
        val = init
        for i in range(int(lower), int(upper)):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _config(pkg, changes):
    """The texture ``clouds_high`` profile with 8 march steps and a baked
    field's knot flag (as the texture plan sets it), changed as given."""
    d, p = pkg["demo"], pkg["params"]
    changes = dict(changes)
    cfg = dataclasses.replace(d.demo_variant("clouds_high", procedural=False),
                              cloud_steps=STEPS, cloud_shape_interp=True)
    if changes.pop("coverage", None) == "procedural":
        changes["cloud_coverage_noise"] = p.ProceduralField(d.COVERAGE_NOISE, d.COVERAGE_SCALE)
    if changes.pop("shape", None) == "procedural":
        changes["cloud_shape_noise"] = p.ProceduralField(d.SHAPE_NOISE_FAST,
                                                         (float(d.SHAPE_TEXTURE_SIZE),) * 3)
    return dataclasses.replace(cfg, **changes)


def _scenes(textures, changes, pose="avatar"):
    """The JAX and the port's demo scene with the baked textures and the
    case's config, updated at t = 0.5."""
    shape, cubemap = textures
    jscene = jdemo.build_demo_scene("clouds_high")
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    for sc, pkg, conv in ((jscene, JAX, jnp.asarray), (scene, PORT, torch.from_numpy)):
        atmo = sc.atmospheres[0]
        atmo.set_shader_parameter("u_cloud_shape_texture", conv(shape))
        atmo.set_shader_parameter("u_cloud_coverage_cubemap", conv(cubemap))
        atmo.set_custom_shader(_config(pkg, changes))
    jcam, cam = jdemo.demo_camera(pose), tdemo.demo_camera(pose, device="cpu")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    return jscene, jcam, scene, cam


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


def _cloud_ok(got, ref):
    """The cloud tolerance."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_exact_sampling_matches_jax_xla(textures, case, eager_jax):
    jscene, jcam, scene, cam = _scenes(textures, CASES[case])
    _, params, configs = scene._sorted_layers(cam)
    config = configs[0]
    assert config.cloud_shape_tex_meta is None and config.cloud_coverage_tex_meta is None
    got = _image({k: v.numpy() for k, v in render_frame(params[0], config, cam, scene.opaque,
                                                         H, W).items()})
    ref = _image(jscene.render(jcam, H, W, renderer="xla"))
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    assert _cloud_ok(got, ref), float(np.abs(got.astype(np.float64) - ref).max())


@pytest.mark.parametrize("case", [c for c in PYRAMID_CASES if c != "group_16"])
def test_pyramid_frame_near_exact(textures, case):
    """``Scene.render`` (the texture plan: a pyramid for each baked field,
    the procedural one beside it as the config has it) against the
    exact-sampling frame; the card's envelope takes the plan's config."""
    _, _, scene, cam = _scenes(textures, PYRAMID_CASES[case])
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    mk.check_config(config)
    for meta, table in zip((config.cloud_shape_tex_meta, config.cloud_coverage_tex_meta), tex):
        assert (meta is None) == (table is None)
    mk.counters.reset()
    pyramid = _image(scene.render(cam, H, W))
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    exact = _image(render_frame(params[0], configs[0], cam, scene.opaque, H, W))
    assert np.isfinite(pyramid).all() and np.abs(exact[..., 3]).max() > 0.05
    assert float(np.abs(pyramid[..., :3] - exact[..., :3]).mean()) < 2e-3


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_pyramid_frame_matches_jax_pallas(textures, monkeypatch, case):
    """The port's pyramid frame against the JAX package's (the Pallas
    megakernel in interpret mode on the plan ``_pallas_plan`` builds):
    the same batches, levels and modes, so the cloud tolerance."""
    jscene, jcam, scene, cam = _scenes(textures, PYRAMID_CASES[case])
    _, jp, jc = jscene._sorted_layers(jcam)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    aug, jtex = jscene._pallas_plan(jp, jc)
    ref = _image(render_scene_pallas(jp, aug, jcam, jscene.opaque, H, W, interpret=True,
                                     tex_data=jtex))
    got = _image(scene.render(cam, H, W))
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    assert _cloud_ok(got, ref), float(np.abs(got.astype(np.float64) - ref).max())


@pytest.mark.parametrize("procedural", ["coverage", "shape"])
def test_mixed_plan_matches_jax_pallas_plan(textures, monkeypatch, procedural):
    """One baked field beside a procedural one: JAX's ``_pallas_plan``
    gives only the baked field a pyramid, its meta and its knot flag, and
    a one-table entry; the port's plan the same meta, the same table and
    ``None`` for the procedural field."""
    jscene, jcam, scene, cam = _scenes(textures, {procedural: "procedural"})
    _, jp, jc = jscene._sorted_layers(jcam)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    aug, jtex = jscene._pallas_plan(jp, jc)
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    assert convert.variant_config_from_fields(dataclasses.asdict(aug[0])) == config
    baked = 1 if procedural == "shape" else 0
    assert tex[1 - baked] is None and len(jtex[0]) == 1
    np.testing.assert_array_equal(tex[baked].numpy(), np.asarray(jtex[0][0]))
    meta = (config.cloud_shape_tex_meta, config.cloud_coverage_tex_meta)
    assert meta[baked] is not None and meta[1 - baked] is None


def _cu_source():
    with open(mk.SOURCE) as f:
        return f.read()


def test_sources_and_layout_match_the_kernel():
    """The source codes and the general instance's constants (its tile
    pass's, its frame's shared memory, the scratch between them) against
    the CUDA source, and the fixed instance's choice against its
    launcher's."""
    src = _cu_source()
    codes = dict(re.findall(r"(MK_SRC_\w+) = (\d+)", src))
    assert {k: int(v) for k, v in codes.items()} == {
        "MK_SRC_PYRAMID": mk.SOURCE_PYRAMID, "MK_SRC_KNOTS": mk.SOURCE_KNOTS,
        "MK_SRC_STEP": mk.SOURCE_STEP}
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (MK_TEXG_\w+) = (\d+);", src)}
    assert consts == {"MK_TEXG_GROUP_FLOATS": mk.TEXG_GROUP_FLOATS,
                      "MK_TEXG_CHOICE_ROWS": mk.TEXG_CHOICE_ROWS, "MK_TEXG_CHUNK": mk.TEXG_CHUNK}
    assert re.search(r"constexpr int MK_NO_CHOICE = (-?\d+);", src).group(1) == str(mk.NO_CHOICE)
    # the frame's shared memory: the knot rows and the march inputs; the tile
    # pass's: the groups' knot inputs and one chunk of partials; the scratch
    layout = re.search(r"static TexgLayout texg_layout\(.*?\n\}", src, re.S).group(0)
    for term in ("MK_GEN_MARCH_ROWS * C", "MK_SMEM_ROWS", "MK_TEXG_CHOICE_ROWS",
                 "MK_TEXG_GROUP_FLOATS * ngr", "MK_TEXG_CHUNK"):
        assert term in layout
    assert "constexpr int MK_TEXG_IN_PLANES = MK_GEN_MARCH_ROWS + 1;" in src
    assert mk.TEXG_IN_PLANES == mk.GEN_MARCH_ROWS + 1
    assert "((long)p.rows * 4 + (long)MK_TEXG_IN_PLANES * texg_coarse_rows(p)) * p.width" in src
    assert re.search(r"constexpr int MK_TEX_GENERAL = (\d+);", src).group(1) == str(
        mk.TEX_GENERAL)
    fixed = re.search(r"static int tex_instance\(.*?\n\}", src, re.S).group(0)
    for term in ("MK_SRC_PYRAMID", "MK_KNOTS", "MK_SHAPE_KNOTS", "always_low", "G == 4",
                 "G == 8", "!general"):
        assert term in fixed


@pytest.mark.parametrize("case", list(PYRAMID_CASES))
def test_launch_structs_carry_each_fields_source(textures, case):
    """What ``tex_constants`` sets for the kernel: each field's source
    (pyramid, procedural knots, procedural per step), the knot counts and
    group; the instance that takes the launch (the fixed one for the
    demo's profile at any knot group); the general instance's two blocks
    (:func:`tex_general_layout`): the frame's 128 threads with its knot rows
    and march inputs, the tile pass's 128 per group row up to 4, within a
    block's shared memory, its slots per tile, and the scratch between
    them."""
    _, _, scene, cam = _scenes(textures, PYRAMID_CASES[case])
    _, params, configs = scene._sorted_layers(cam)
    config, _ = scene._texture_plan(params[0], configs[0])
    t = mk.tex_constants(config)
    s = mk.frame_constants(params[0], config, cam, scene.opaque, H, W)
    want = {}
    for name, meta, noise, interp in (
            ("shape", config.cloud_shape_tex_meta, config.cloud_shape_noise,
             config.cloud_shape_interp),
            ("cov", config.cloud_coverage_tex_meta, config.cloud_coverage_noise,
             config.cloud_coverage_interp)):
        want[name] = (mk.SOURCE_PYRAMID if meta is not None
                      else mk.SOURCE_KNOTS if interp else mk.SOURCE_STEP)
        assert (meta is None) == (noise is not None)
    assert (t.shape_source, t.cov_source) == (want["shape"], want["cov"])
    assert (t.knot_group, t.shape_knots) == (config.texture_knot_group, config.cloud_shape_knots)
    assert mk.fixed_texture_instance(s, t) == case.startswith("knot_group")
    lay = mk.tex_general_layout(config)
    group_rows = 32 // (config.cloud_lod * config.cloud_coverage_lod)
    assert lay["threads"] == 128 and lay["choice_threads"] == 128 * min(4, group_rows)
    rows = mk.knot_rows(config) + mk.GEN_MARCH_ROWS * config.cloud_coverage_lod
    assert lay["smem_bytes"] == rows * mk.TILE_COLS * 4 <= mk.SMEM_ROWS * mk.TILE_COLS * 4
    assert 0 < lay["choice_smem_bytes"] <= mk.SMEM_ROWS * mk.TILE_COLS * 4
    assert mk.tex_choice_shape(s, t) == ((H // 32) * (W // 128), lay["slots"], 2)
    coarse_rows = H // (config.cloud_lod * config.cloud_coverage_lod) * config.cloud_coverage_lod
    assert mk.tex_scratch_floats(s) == (H * 4 + mk.TEXG_IN_PLANES * coarse_rows) * W


@pytest.mark.parametrize("procedural", ["coverage", "shape"])
def test_mixed_layer_shards_assemble_the_frame(textures, procedural):
    """The band entries take a mixed layer's one-table ``tex_data``: two
    row shards through ``parallel/sharding.py`` (the local mesh) put
    together equal the whole frame bit for bit (each shard's pyramid
    batches are the frame's, its rows starting on a tile)."""
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import (
        make_mesh, render_scene_megakernel_sharded)

    _, _, scene, cam = _scenes(textures, {procedural: "procedural"})
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    assert sum(t is None for t in tex) == 1
    full = mk.render_scene_megakernel(params, (config,), cam, scene.opaque, H, W,
                                      tex_data=(tex,))
    sharded = render_scene_megakernel_sharded(params, (config,), cam, scene.opaque, H, W,
                                              make_mesh(2), tex_data=(tex,))
    assert torch.equal(sharded["color"], full["color"])
    assert torch.equal(sharded["alpha"], full["alpha"])
