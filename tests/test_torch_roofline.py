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
