"""The megakernel module: plain version vs JAX, dispatch, build, binding.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself runs only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
The JAX reference frame is the XLA path (``render_frame``), which
``tests/test_pallas.py`` pins to the TPU megakernel at 1e-5.
"""

import ctypes
import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models.demo import build_demo_scene, demo_camera
from godot_atmosphere_shader_tpu.render.renderer import render_frame
from godot_atmosphere_shader_tpu_torch.models.convert import (
    atmosphere_params_from_numpy, camera_from_numpy, opaque_from_numpy,
    variant_config_from_fields)
from godot_atmosphere_shader_tpu_torch.models.demo import demo_variant
from godot_atmosphere_shader_tpu_torch.ops.kernels import library
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

torch.set_num_threads(2)

H, W = 48, 64


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _frame(variant, pose="exterior"):
    """JAX demo inputs and their port twins (carried across by convert)."""
    scene = build_demo_scene(variant)
    cam = demo_camera(pose)
    scene.update(0.5, cam)
    atmo = scene.atmospheres[0]
    jp, cfg = atmo.build_params(), atmo.effective_config()
    port = (atmosphere_params_from_numpy(_fields(jp), device="cpu"),
            variant_config_from_fields(dataclasses.asdict(cfg)),
            camera_from_numpy(_fields(cam), device="cpu"),
            opaque_from_numpy(_fields(scene.opaque), device="cpu"))
    return (jp, cfg, cam, scene.opaque), port


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]],
                          axis=-1)


@pytest.fixture(scope="module")
def clouds_high():
    jax_in, port_in = _frame("clouds_high")
    jp, cfg, cam, opaque = jax_in
    ref = _image(render_frame((jp,), (cfg,), cam, opaque, H, W))
    return ref, port_in


def test_plain_matches_jax_clouds_high(clouds_high):
    ref, port_in = clouds_high
    mk.counters.reset()
    got = _image({k: v.numpy() for k, v in mk.render_frame_megakernel(*port_in, H, W).items()})
    assert mk.counters.plain_calls == 1 and mk.counters.megakernel_launches == 0
    assert np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - ref)
    # cloud tolerance: knife-edge noise cells flip on ulp-level differences
    assert np.percentile(d, 99.9) <= 1e-3
    assert d.mean() <= 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() <= 1e-3


@pytest.mark.parametrize("pose", ["exterior", "avatar"])
def test_plain_matches_jax_no_clouds(pose):
    (jp, cfg, cam, opaque), port_in = _frame("no_clouds", pose)
    ref = _image(render_frame((jp,), (cfg,), cam, opaque, H, W))
    got = _image({k: v.numpy() for k, v in mk.render_frame_plain(*port_in, H, W).items()})
    # the tolerance tests/test_pallas.py holds the TPU kernel to against the
    # same XLA frame: grazing limb rays amplify FMA-contraction differences
    # in the shell chord to ~1e-5 relative in alpha
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_plain_returns_depth_buffer(clouds_high):
    out = mk.render_frame_plain(*clouds_high[1], H, W)
    assert out["depth"].shape == (H, W) and out["color"].shape == (H, W, 3)
    # the wrapper returns the same keys on every device
    assert set(mk.render_frame_megakernel(*clouds_high[1], 8, 16)) == {"color", "alpha"}


def test_cpu_tensors_take_the_plain_path(clouds_high):
    mk.counters.reset()
    mk.render_frame_megakernel(*clouds_high[1], 8, 16)
    mk.render_frame_megakernel(*clouds_high[1], 8, 16)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (2, 0)


def _noise(field, **kw):
    return dataclasses.replace(field, noise=dataclasses.replace(field.noise, **kw))


_SHAPE = demo_variant("clouds_high").cloud_shape_noise
_COVERAGE = demo_variant("clouds_high").cloud_coverage_noise


@pytest.mark.parametrize("change", [
    dict(od_mode="lut"), dict(model="v3"), dict(cloud_shape_noise=None),
    dict(cloud_coverage_noise=None), dict(cloud_lod=0),
    dict(cloud_lod=3), dict(cloud_lod=32),
    dict(cloud_shape_noise=_noise(_SHAPE, fractal_type="bogus")), dict(cloud_coverage_lod=3),
    dict(cloud_coverage_lod=0),
    dict(cloud_coverage_noise=_noise(_COVERAGE, cellular_return="bogus")),
    dict(cloud_shape_tex_meta=object()),
    dict(cloud_shape_noise=_noise(_SHAPE, noise_type="worley")),
    dict(cloud_coverage_tex_meta=object()),
])
def test_wrapper_rejects_unsupported_config(clouds_high, change):
    """The kernel's envelope: ``check_config`` refuses each of these (the
    wrapper applies it to CUDA tensors; on the CPU the plain chain refuses
    only what the plain ops do not take): no LUT, no other model, no
    procedural field beside a baked one without pyramids, a LOD group
    dividing the 32-row tile, known bases, fractals and cellular returns
    (any octave count: the octaves beyond the struct's come from the scene
    buffer)."""
    params, cfg, cam, opaque = clouds_high[1]
    with pytest.raises(ValueError):
        mk.check_config(dataclasses.replace(cfg, **change))


@pytest.mark.parametrize("change", [
    dict(cloud_coverage_interp=False), dict(cloud_shape_interp=True),
    dict(cloud_coverage_knots=7), dict(cloud_lod=8), dict(cloud_lod=16),
    dict(clouds_always_low_quality=False), dict(knot_dynamic=False),
    dict(cloud_shape_interp=True, cloud_shape_knots=32, clouds_always_low_quality=False,
         cloud_coverage_knots=64),
    dict(cloud_shape_noise=_noise(_SHAPE, noise_type="cellular", cellular_return="cell_value")),
    dict(cloud_coverage_noise=_noise(_COVERAGE, fractal_type="ping_pong",
                                     weighted_strength=0.3)),
    dict(cloud_shape_noise=_noise(_SHAPE, octaves=10)),
    dict(cloud_coverage_noise=_noise(_COVERAGE, octaves=9, warp_octaves=10)),
])
def test_general_instance_takes_the_procedural_envelope(clouds_high, change):
    """Every procedural config the JAX megakernel renders passes
    ``check_config`` and takes the procedural instance, not the texture
    instance."""
    cfg = dataclasses.replace(clouds_high[1][1], **change)
    mk.check_config(cfg)
    assert not mk.texture_mode(cfg)


def test_knot_rows_have_a_limit(clouds_high):
    """The procedural instance's knots live in shared memory beside the
    march inputs: coverage, shape and detail knots (+1 each) and
    GEN_MARCH_ROWS rows per coarse pixel fit the SMEM_ROWS rows (227 KB) a
    block may use, else ``check_config`` refuses."""
    cfg = dataclasses.replace(clouds_high[1][1], cloud_shape_interp=True,
                              clouds_always_low_quality=False, cloud_shape_knots=210,
                              cloud_coverage_knots=40)
    assert cfg.cloud_coverage_lod == 2
    assert mk.knot_rows(cfg) + 2 * mk.GEN_MARCH_ROWS == 41 + 2 * 211 + 12 > mk.SMEM_ROWS
    assert mk.gen_smem(cfg) == (None, False)
    with pytest.raises(ValueError, match="knot rows"):
        mk.check_config(cfg)
    fits = dataclasses.replace(cfg, cloud_coverage_knots=8)
    assert mk.gen_smem(fits) == ((9 + 422 + 12) * 512, False)  # no room for the row cache
    mk.check_config(fits)
    # 32 coarse pixels per thread: 192 rows of march inputs leave 262 for knots
    wide = dataclasses.replace(fits, cloud_lod=1, cloud_coverage_lod=32, cloud_lod_interior=0,
                               cloud_shape_knots=125)
    assert mk.knot_rows(wide) + 32 * mk.GEN_MARCH_ROWS == 9 + 252 + 192 <= mk.SMEM_ROWS
    mk.check_config(wide)
    with pytest.raises(ValueError, match="knot rows"):
        mk.check_config(dataclasses.replace(wide, cloud_shape_knots=126))


@pytest.mark.parametrize("change,rows,cache", [
    (dict(), 9 + 2 * 6 + 4 * 4, True),  # the demo profile: 9 knots, C = 2, G = 4
    (dict(cloud_lod=4), 9 + 2 * 6 + 8 * 4, True),  # its interior LOD
    (dict(cloud_lod=1, cloud_coverage_lod=32), 9 + 32 * 6 + 32 * 4, True),
    (dict(cloud_lod=16, cloud_coverage_lod=2), 9 + 2 * 6 + 32 * 4, True),
    (dict(cloud_coverage_interp=False, cloud_lod=1, cloud_coverage_lod=1), 6 + 4, True),
    (dict(cloud_shape_interp=True, cloud_shape_knots=300), 9 + 301 + 12 + 16, True),
    (dict(cloud_shape_interp=True, cloud_shape_knots=420), 9 + 421 + 12, False),
    (dict(cloud_lod=1, cloud_coverage_lod=32, cloud_shape_interp=True, cloud_shape_knots=130),
     9 + 131 + 192, False),
])
def test_gen_smem_budget_matches_the_kernel(clouds_high, change, rows, cache):
    """The wrapper's shared-memory budget (knot rows, the march inputs, the
    row cache where it fits) as the launcher lays it out with the ``.cu``'s
    constants, within the 232,448 bytes a block may use."""
    cfg = dataclasses.replace(clouds_high[1][1], cloud_lod_interior=0, **change)
    mk.check_config(cfg)
    assert mk.gen_smem(cfg) == (rows * mk.TILE_COLS * 4, cache)
    defines = {k: int(v) for k, v in re.findall(r"#define (MK_\w+) (\d+)", _cu_source())}
    assert (defines["MK_SMEM_ROWS"], defines["MK_GEN_MARCH_ROWS"],
            defines["MK_GEN_CACHE_ROWS"]) == (mk.SMEM_ROWS, mk.GEN_MARCH_ROWS, mk.GEN_CACHE_ROWS)
    assert mk.SMEM_ROWS * mk.TILE_COLS * 4 == 232448
    body = re.search(r"__global__ void __launch_bounds__\(MK_TILE_COLS, gen_min_blocks\)"
                     r".*?\n\}", _cu_source(), re.S).group(0)
    assert "__shared__ float smem[]" in body and body.count("__shared__") == 1


_GROUPS = [(g, lod) for g in (1, 2, 4, 8, 16, 32) for lod in (1, 2, 4, 8, 16, 32) if g % lod == 0]


@pytest.mark.parametrize("group,lod", _GROUPS)
def test_launcher_instantiates_every_coarse_count(clouds_high, group, lod):
    """``check_config`` passes every LOD group dividing the 32-row tile, and
    the launcher (``gen_layout``) has the instances ``megakernel_gen<C,
    EXT>`` (the launch reads the scene buffer or not) for its C =
    cloud_coverage_lod coarse pixels per thread."""
    cfg = dataclasses.replace(clouds_high[1][1], cloud_lod=lod, cloud_coverage_lod=group // lod,
                              cloud_lod_interior=0)
    mk.check_config(cfg)
    body = re.search(r"static GenLayout gen_layout\(.*?\n\}", _cu_source(), re.S).group(0)
    cases = {int(a): (int(b), int(c)) for a, b, c in re.findall(
        r"case (\d+): out\.kernel = ext \? megakernel_gen<(\d+), true> : "
        r"megakernel_gen<(\d+), false>;", body)}
    assert all(a == b == c for a, (b, c) in cases.items())
    assert set(cases) == set(mk.GEN_COARSE)
    assert cfg.cloud_coverage_lod in cases


def test_wrapper_takes_temporal_jitter(clouds_high):
    """Flight mode's per-frame jitter is in the kernel slice."""
    params, cfg, cam, opaque = clouds_high[1]
    mk.check_config(dataclasses.replace(cfg, temporal_jitter=True))


def test_wrapper_rejects_unported_noise(clouds_high):
    """Every basis is ported; the 8-cell cellular has no F2 returns (JAX
    raises on them too)."""
    params, cfg, cam, opaque = clouds_high[1]
    field = dataclasses.replace(cfg.cloud_shape_noise, noise=dataclasses.replace(
        cfg.cloud_shape_noise.noise, noise_type="cellular_fast", cellular_return="distance2"))
    with pytest.raises(ValueError):
        mk.check_config(dataclasses.replace(cfg, cloud_shape_noise=field))
    mk.check_config(dataclasses.replace(cfg, cloud_shape_noise=_noise(
        field, cellular_return="distance")))


def test_demo_profile_is_in_the_kernel_slice():
    for variant in ("no_clouds", "clouds", "clouds_high", "clouds_high_rm", "v1_no_clouds",
                    "v1_clouds", "v1_clouds_high"):
        mk.check_config(demo_variant(variant))
        assert not mk.texture_mode(demo_variant(variant))
        mk.check_config(demo_variant(variant, shape_basis="cellular"))


# -- the CUDA source and its ctypes binding ------------------------------------

_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "const float*": ctypes.c_void_p}


def _cu_source():
    with open(mk.SOURCE) as f:
        return f.read()


def _cu_struct(name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, _cu_source(), re.S).group(1)
    defines = {k: int(v) for k, v in re.findall(r"#define (MK_\w+) (\d+)", _cu_source())}
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(\w+|const float\*) (\w+)(?:\[(.+)\])?;", line)
        assert m, line
        ctype, fname, size = m.groups()
        n = eval(size, {}, defines) if size else None  # e.g. MK_INLINE_SPHERES * 3
        fields.append((fname, ctype, n))
    return fields


@pytest.mark.parametrize("struct", [mk.MegakernelParams, mk.NoiseParams, mk.TexParams])
def test_cu_structs_match_ctypes_mirror(struct):
    """Same fields, order, types and array lengths on both sides."""
    want = []
    for fname, ctype, n in _cu_struct(struct.__name__):
        if ctype in _CTYPE:
            want.append((fname, _CTYPE[ctype] if n is None else _CTYPE[ctype] * n))
        else:
            want.append((fname, getattr(mk, ctype)))
    got = list(struct._fields_)
    assert [f for f, _ in got] == [f for f, _ in want]
    for (fname, t_got), (_, t_want) in zip(got, want):
        assert t_got == t_want or (
            issubclass(t_got, ctypes.Array) and t_got._type_ == t_want._type_
            and t_got._length_ == t_want._length_), fname


def test_cu_limits_match_wrapper():
    defines = {k: int(v) for k, v in re.findall(r"#define (MK_\w+) (\d+)", _cu_source())}
    work = {f"MK_WORK_{name.upper()}": i for i, name in enumerate(mk.WORK_SLOTS)}
    stages = {f"MK_STAGE_{name.upper()}": i for i, name in enumerate(mk.STAGE_SLOTS)}
    assert defines == {"MK_INLINE_SPHERES": mk.INLINE_SPHERES,
                       "MK_INLINE_BOXES": mk.INLINE_BOXES,
                       "MK_INLINE_OCTAVES": mk.INLINE_OCTAVES, "MK_GEOM_SPHERE": mk.GEOM_SPHERE,
                       "MK_GEOM_BOX": mk.GEOM_BOX, "MK_EXT_OCTAVE": mk.EXT_OCTAVE,
                       "MK_MAX_GROUP": mk.MAX_GROUP,
                       "MK_QUAD_POINTS": mk.QUAD_POINTS, "MK_KNOTS": mk.KNOTS,
                       "MK_SMEM_ROWS": mk.SMEM_ROWS, "MK_GEN_MARCH_ROWS": mk.GEN_MARCH_ROWS,
                       "MK_GEN_CACHE_ROWS": mk.GEN_CACHE_ROWS,
                       "MK_SHAPE_KNOTS": mk.SHAPE_KNOTS, "MK_MAX_LEVELS": mk.MAX_LEVELS,
                       "MK_TILE_ROWS": mk.TILE_ROWS, "MK_TILE_COLS": mk.TILE_COLS,
                       "MK_WINDOWED": mk.WINDOWED, "MK_BANDED": mk.BANDED,
                       "MK_FLOOR": mk.FLOOR, **work, "MK_WORK_SLOTS": len(mk.WORK_SLOTS),
                       **stages, "MK_STAGES": len(mk.STAGE_SLOTS),
                       "MK_SUN_STEPS": mk.SUN_STEPS}


def _cu_constexpr(name):
    """A texture ``constexpr int`` of the source (``MK_TEX_*``), its terms
    (``MK_*`` defines and the constexprs before it) substituted."""
    terms = {k: int(v) for k, v in re.findall(r"#define (MK_\w+) (\d+)", _cu_source())}
    for const, expr in re.findall(r"constexpr int (MK_TEX_\w+) = (.*?);", _cu_source()):
        terms[const] = eval(expr.replace("/", "//"), {}, terms)
    return terms[name]


def test_texture_layout_matches_wrapper():
    """The texture instance's threads, resident threads per SM and shared
    memory, as ``tex_threads`` and ``tex_smem`` mirror them, against the
    source's constants and its ``tex_threads`` and ``tex_smem``."""
    src = _cu_source()
    assert _cu_constexpr("MK_TEX_SM_THREADS") == mk.TEX_SM_THREADS
    assert _cu_constexpr("MK_TEX_KNOT_ROWS") == mk.TEX_KNOT_ROWS == mk.KNOTS + mk.SHAPE_KNOTS + 2
    assert _cu_constexpr("MK_TEX_RED_SLOTS") == mk.TEX_RED_SLOTS
    threads_expr = re.search(r"constexpr int tex_threads\(int G\) \{ return (.*?); \}",
                             src).group(1)
    smem_expr = re.search(r"constexpr int tex_smem\(int G\) \{\s*return (.*?);\s*\}", src,
                          re.S).group(1)
    for g in mk.TEXTURE_GROUPS:
        threads = eval(threads_expr.replace("/", "//"), {}, {
            "G": g, "MK_TILE_COLS": mk.TILE_COLS, "MK_TILE_ROWS": mk.TILE_ROWS})
        assert threads == mk.tex_threads(g) and mk.TEX_SM_THREADS % threads == 0
        smem = eval(" ".join(smem_expr.split()).replace("tex_threads(G)", str(threads))
                    .replace("(int)sizeof(float)", "4").replace("/", "//"), {}, {
                        "MK_TEX_KNOT_ROWS": mk.TEX_KNOT_ROWS, "MK_TEX_RED_SLOTS": mk.TEX_RED_SLOTS})
        assert smem == mk.tex_smem(g)


def test_texture_launcher_has_an_instance_per_group():
    """``megakernel_tex_launch`` dispatches each G of TEXTURE_GROUPS to its
    own ``megakernel_tex<K, KS, G, EXT>`` (EXT: the launch reads the scene
    buffer or not), and nothing else; so does the occupancy query."""
    src = _cu_source()
    launch = re.search(r'extern "C" int megakernel_tex_launch\(.*?\n\}', src, re.S).group(0)
    assert re.findall(r"if \(G == (\d+)\)\s*return launch_tex<(\d+)>", launch) == [
        (str(g), str(g)) for g in mk.TEXTURE_GROUPS]
    body = re.search(r"static int launch_tex\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, G, (\w+)>", body) == [
        "true", "false"]
    info = re.search(r'extern "C" int megakernel_tex_info\(.*?\n\}', src, re.S).group(0)
    assert re.findall(r"megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, (\d+), (\w+)>", info) == [
        (str(g), ext) for g in mk.TEXTURE_GROUPS for ext in ("true", "false")]


@pytest.mark.parametrize("group,coverage_lod", [(g, c) for g in mk.TEXTURE_GROUPS
                                                for c in (1, 2, 4, 8) if g % c == 0])
def test_every_texture_config_fits_one_cta(group, coverage_lod):
    """Every split of G rows into cloud_lod·coverage_lod that
    ``check_config`` passes is one block per tile whose shared memory fits
    the 227 KB a block may use, and TEX_SM_THREADS resident threads per SM
    hold whole tiles whose shared memory fits an SM too (two at G = 8)."""
    cfg = dataclasses.replace(demo_variant("clouds_high", procedural=False),
                              cloud_lod=group // coverage_lod, cloud_coverage_lod=coverage_lod)
    assert not [p for p in mk._texture_problems(cfg) if "cloud_lod" in p]
    threads = mk.tex_threads(cfg.cloud_lod * cfg.cloud_coverage_lod)
    smem = mk.tex_smem(cfg.cloud_lod * cfg.cloud_coverage_lod)
    tiles = mk.TEX_SM_THREADS // threads
    assert threads <= 1024 and tiles == (2 if group == 8 else 1)
    assert 0 < tiles * smem <= mk.SMEM_ROWS * mk.TILE_COLS * 4, (group, coverage_lod)


_CPARAM = {"int": ctypes.c_int, "const MegakernelParams*": ctypes.POINTER(mk.MegakernelParams),
           "const TexParams*": ctypes.POINTER(mk.TexParams)}


@pytest.mark.parametrize("name,argtypes", [("megakernel_launch", mk.LAUNCHER_ARGTYPES),
                                           ("sky_choice_launch", mk.SKY_CHOICE_ARGTYPES),
                                           ("megakernel_tex_launch", mk.TEX_LAUNCHER_ARGTYPES),
                                           ("texsample_launch", mk.TEXSAMPLE_ARGTYPES),
                                           ("megakernel_gen_info", mk.GEN_INFO_ARGTYPES),
                                           ("megakernel_tex_info", mk.TEX_INFO_ARGTYPES),
                                           ("megakernel_clear_info", mk.CLEAR_INFO_ARGTYPES),
                                           ("megakernel_work_slots", ())])
def test_cu_launcher_signature_matches_argtypes(name, argtypes):
    """Each launcher's C parameters against its ctypes argtypes: structs by
    pointer, ints as c_int, every other pointer (and the stream) c_void_p."""
    sig = re.search(r'extern "C" int %s\((.*?)\)' % name, _cu_source(), re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")] if sig != "void" else []
    want = tuple(_CPARAM.get(p.rsplit(" ", 1)[0], ctypes.c_void_p) for p in params)
    assert argtypes == want, params
    if name == "megakernel_launch":
        assert params == ["const MegakernelParams* params", "const TexParams* sky",
                          "const float* blue", "const float* sky_r", "const float* sky_g",
                          "const float* sky_b", "const int* sky_choices", "float* color",
                          "float* alpha", "float* depth", "void* stream", "void* work"]
    if name == "sky_choice_launch":
        assert params == ["const MegakernelParams* params", "const TexParams* sky",
                          "int* choices", "void* stream"]
    if name == "megakernel_tex_launch":
        assert params[:3] == ["const MegakernelParams* params", "const TexParams* tex",
                              "const TexParams* sky"]
        assert params[6:9] == ["const float* sky_r", "const float* sky_g", "const float* sky_b"]
        assert params[-4:] == ["int* choices", "int choice_ints", "float* scratch",
                               "int scratch_floats"]


def test_build_command_and_cache_key(monkeypatch, tmp_path):
    cmd = library.nvcc_command("out.o", mk.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert "--use_fast_math" not in cmd and "-fmad=true" in cmd
    assert library.library_path().startswith(library.BUILD_DIR)
    assert mk.SOURCE in library.SOURCES
    # an edit of any source gives the library a new name, so it rebuilds
    before = library.library_path()
    for i, source in enumerate(library.SOURCES):
        edited = tmp_path / os.path.basename(source)
        with open(source) as f:
            edited.write_text(f.read() + "\n// edit\n")
        sources = list(library.SOURCES)
        sources[i] = str(edited)
        monkeypatch.setattr(library, "SOURCES", tuple(sources))
        assert library.library_path() != before, source
        monkeypatch.undo()


def test_failed_build_raises_with_compiler_stderr(monkeypatch, tmp_path):
    def failing(output, source, ptxas_info=False, defines=()):
        return [sys.executable, "-c", "import sys; sys.stderr.write('bad kernel'); sys.exit(2)"]

    monkeypatch.setattr(library, "nvcc_command", failing)
    with pytest.raises(RuntimeError, match="bad kernel"):
        library.build(build_dir=str(tmp_path))
    assert not os.listdir(tmp_path)  # no object or library left behind
