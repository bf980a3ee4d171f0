"""The roofline bound of ``chip_smoke.py``: what it charges a launch's
atmosphere.

A launch's v2 and v1 integrations cost operations per step of the layer's
``atmosphere_steps`` (8 for the demo variants, 16 for v1, 64 for the gas
giant), and v2 its sun depth's quadrature segments as the kernel counted
them in the work slot ``od_segments``: the kernel skips a segment that is
empty, so these inputs may need fewer than two per step.  The slot's index
is mirrored between ``csrc/megakernel.cu`` and the wrapper.  No card: the
bound is arithmetic on work counts.
"""

import dataclasses
import re

import pytest

import chip_smoke as cs
from godot_atmosphere_shader_tpu_torch.models.params import PROFILES, VARIANTS
from godot_atmosphere_shader_tpu_torch.ops.kernels import library
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

H, W = 1080, 1920
N = 100_000  # integrations of the launch


def _work(**counts):
    work = dict.fromkeys(mk.WORK_SLOTS, 0)
    work.update(counts)
    return work


def _atmosphere_ops(config, **counts):
    """The operations the bound charges for ``counts`` beyond a launch
    without atmosphere."""
    return (cs.roofline(_work(pixels=N, **counts), config, H, W)["ops"]
            - cs.roofline(_work(pixels=N), config, H, W)["ops"])


def test_v2_atmosphere_follows_the_step_count():
    """The gas giant's 64 steps are charged 8 times the 8-step demo
    variant's per-step operations, each step with its two segments; the
    per-pixel remainder once."""
    demo, giant = VARIANTS["no_clouds"], PROFILES["gas_giant"]
    assert (demo.atmosphere_steps, giant.atmosphere_steps) == (8, 64)
    per = {}
    for config in (demo, giant):
        steps = config.atmosphere_steps
        per[steps] = (_atmosphere_ops(config, atmosphere=N, od_segments=2 * steps * N)
                      - N * cs.OPS_V2_PIXEL)
    assert per[64] == 8 * per[8] > 0
    assert per[8] == 8 * N * (cs.OPS_V2_STEP + 2 * cs.OPS_OD_SEGMENT)


def test_v1_atmosphere_follows_its_own_step_count():
    """v1 is charged per step of its own config (16 in the reference's v1
    variants), not v2's count, and 32 steps twice 16."""
    v1 = VARIANTS["v1_no_clouds"]
    assert v1.model == "v1" and v1.atmosphere_steps == 16
    ops16 = _atmosphere_ops(v1, v1_atmosphere=N)
    assert ops16 == N * (cs.OPS_V1_PIXEL + 16 * cs.OPS_V1_STEP)
    v1_32 = dataclasses.replace(v1, atmosphere_steps=32)
    assert _atmosphere_ops(v1_32, v1_atmosphere=N) - N * cs.OPS_V1_PIXEL == 2 * (
        ops16 - N * cs.OPS_V1_PIXEL)


def test_od_segments_slot_index_matches_the_kernel():
    """``MK_WORK_OD_SEGMENTS`` and ``MK_WORK_SLOTS`` in the source equal the
    wrapper's slot index and count, and every instance counts the slot."""
    with open(next(s for s in library.SOURCES if s.endswith("megakernel.cu"))) as f:
        src = f.read()
    defines = dict(re.findall(r"#define (MK_WORK_\w+) (\d+)", src))
    assert int(defines["MK_WORK_OD_SEGMENTS"]) == mk.WORK_SLOTS.index("od_segments")
    assert int(defines["MK_WORK_SLOTS"]) == len(mk.WORK_SLOTS)
    for kernel in ("megakernel_clear(", "megakernel_gen(", "megakernel_tex("):
        body = src[src.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "count_work(work, MK_WORK_OD_SEGMENTS, n_seg);" in body, kernel


def test_one_segment_per_step_is_charged_less_than_two():
    """A v2 pixel whose every step evaluated one quadrature segment (the
    other empty) is charged one segment's operations less per step than
    one that evaluated both; more segments than two per step refuse."""
    giant = PROFILES["gas_giant"]
    steps = giant.atmosphere_steps
    one = _atmosphere_ops(giant, atmosphere=N, od_segments=steps * N)
    two = _atmosphere_ops(giant, atmosphere=N, od_segments=2 * steps * N)
    assert 0 < one < two and two - one == steps * N * cs.OPS_OD_SEGMENT
    with pytest.raises(RuntimeError, match="quadrature segments"):
        _atmosphere_ops(giant, atmosphere=N, od_segments=2 * steps * N + 1)


def _general_launch(cov, shape, always_low, lod=1, coverage_lod=1):
    """A 1080p launch struct and texture params of the general texture
    instance: the fields' sources, the quality and the LOD group."""
    struct = mk.MegakernelParams()
    struct.rows, struct.width, struct.height = H, W, H
    struct.cloud_lod, struct.coverage_lod = lod, coverage_lod
    struct.coverage_knots, struct.shape_knots, struct.always_low = 8, 16, always_low
    tparams = mk.TexParams()
    tparams.knot_group, tparams.cov_source, tparams.shape_source = 8, cov, shape
    return struct, tparams


def _texture_config():
    """``clouds_high`` with both fields baked (the bound reads only whether
    a field has a pyramid's meta) and no procedural work counted."""
    return dataclasses.replace(VARIANTS["clouds_high"], cloud_coverage_tex_meta=object(),
                               cloud_shape_tex_meta=object())


# (coverage source, shape source, low quality): the 4g frames' kinds
GENERAL_KINDS = [(mk.SOURCE_PYRAMID, mk.SOURCE_PYRAMID, 1),
                 (mk.SOURCE_PYRAMID, mk.SOURCE_PYRAMID, 0),
                 (mk.SOURCE_KNOTS, mk.SOURCE_PYRAMID, 1),
                 (mk.SOURCE_PYRAMID, mk.SOURCE_STEP, 1)]


@pytest.mark.parametrize("cov,shape,low", GENERAL_KINDS)
def test_general_texture_bound_is_split_by_launch(cov, shape, low):
    """The general texture instance's two launches share the launch's work:
    the tile pass the pixels' shading and atmosphere, its padded tile
    grid's coarse pixels and the unsampled groups' knot coordinates, the
    blue noise and its choices; the frame the blend, the clouds, the frame
    planes and the pyramids.  Together they are the one-launch bound's
    work and the tile pass's own; with fp32 work alone the bound is the
    sum of the two launches'."""
    config = _texture_config()
    struct, tparams = _general_launch(cov, shape, low)
    groups = 34 * 15 * 32 * 128  # the padded tile grid at G = 1
    work = _work(pixels=H * W, atmosphere=N, od_segments=2 * config.atmosphere_steps * N,
                 march=N, tex3d=3 * N, latlong=2 * N, knot_groups=groups // 2)
    one = cs.roofline(work, config, H, W, table_bytes=1000)
    b = cs.tex_general_roofline(work, config, struct, tparams, 1000, H * W * cs.BYTES_LAYER_PIXEL)
    tile, frame = b["tile"], b["frame"]
    tiles, slots, _ = mk.tex_choice_shape(struct, tparams)
    coarse = groups * cs.OPS_CHOICE_COARSE
    coords = (tile["ops"] - coarse - H * W * cs.OPS_SHADE_PIXEL - cs.atmosphere_ops(work, config))
    assert coords > 0 and coords % (groups // 2) == 0
    assert frame["ops"] == (H * W * cs.OPS_BLEND_PIXEL + N * config.cloud_steps * cs.OPS_STEP
                            + 3 * N * cs.OPS_TEX3D + 2 * N * cs.OPS_LATLONG)
    assert tile["ops"] + frame["ops"] == one["ops"] + coarse + coords
    assert (tile["int_ops"], frame["int_ops"]) == (0, one["int_ops"])
    assert tile["bytes"] + frame["bytes"] == one["bytes"] + tiles * slots * 8
    assert b["bound_ms"] == pytest.approx(tile["bound_ms"] + frame["bound_ms"], rel=1e-12)
    assert (b["ops"], b["bytes"]) == (tile["ops"] + frame["ops"], tile["bytes"] + frame["bytes"])


def test_general_texture_bound_is_the_functions():
    """Where the frame's procedural noise makes it bound by int32
    instructions, the instance's bound is its work's as one launch's: below
    the sum of the two launches' bounds (the tile pass's fp32 work fits
    beside the noise's int32), not below the larger of them."""
    from godot_atmosphere_shader_tpu_torch.models.demo import demo_variant

    config = dataclasses.replace(demo_variant("clouds_high"), cloud_coverage_tex_meta=object())
    struct, tparams = _general_launch(mk.SOURCE_PYRAMID, mk.SOURCE_STEP, 1)
    groups = 34 * 15 * 32 * 128
    work = _work(pixels=H * W, march=N, latlong=9 * N, knot_groups=N, shape_evals=400 * N)
    b = cs.tex_general_roofline(work, config, struct, tparams, 0, H * W * cs.BYTES_LAYER_PIXEL)
    tile, frame = b["tile"], b["frame"]
    assert frame["int_ops"] > 0 and tile["int_ops"] == 0 < groups - N
    assert cs.ops_time_ms(0, frame["int_ops"]) == frame["bound_ms"]
    assert max(tile["bound_ms"], frame["bound_ms"]) <= b["bound_ms"]
    assert b["bound_ms"] < tile["bound_ms"] + frame["bound_ms"]


@pytest.mark.parametrize("cov,shape,low", GENERAL_KINDS)
def test_sampled_groups_charge_their_knot_coordinates_once(cov, shape, low):
    """A coverage group the frame samples pays for its knots' coordinates
    and its share of the choice in its samples (OPS_TEX3D, OPS_LATLONG);
    the tile pass charges them only for the groups it reads alone: each
    unsampled group adds every baked knot's OPS_CHOICE_COORD, a sampled
    one nothing."""
    config = _texture_config()
    struct, tparams = _general_launch(cov, shape, low)
    groups = 34 * 15 * 32 * 128

    def tile_ops(sampled):
        work = _work(pixels=H * W, knot_groups=sampled)
        return cs.tex_general_roofline(work, config, struct, tparams, 0,
                                       H * W * cs.BYTES_LAYER_PIXEL)["tile"]["ops"]

    per_group = 0
    if cov == mk.SOURCE_PYRAMID:
        per_group += 9 * cs.OPS_CHOICE_COORD[0]
    if shape == mk.SOURCE_PYRAMID:
        per_group += 17 * (cs.OPS_CHOICE_COORD[1] + (0 if low else cs.OPS_CHOICE_COORD[2]))
    assert tile_ops(groups) == H * W * cs.OPS_SHADE_PIXEL + groups * cs.OPS_CHOICE_COARSE
    assert tile_ops(groups - 1000) - tile_ops(groups) == 1000 * per_group
    with pytest.raises(RuntimeError, match="coverage groups sampled"):
        tile_ops(groups + 1)
