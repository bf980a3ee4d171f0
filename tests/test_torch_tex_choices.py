"""The general texture instance's tile choices on the CPU: their plain version
``megakernel.tex_choices_plain`` against the choices the plain chain makes.

The CUDA kernel ``tex_choice_kernel`` (``csrc/megakernel.cu``) writes, per
32×128 tile, the sky's (mode, level) and each knot batch's, and the frame
kernel samples every knot with its batch's choice; the card tests and
``chip_smoke.py`` hold that buffer exactly against ``tex_choices_plain``.
Here, on the CPU, ``tex_choices_plain`` is held against the choices of the
plain samplers in ``Scene.render``'s plain chain (each batched knot
sampler call's, recorded by ``texsample.record_batch_choices``) for
``chip_smoke.py`` phase 3h's 19 texture configs at 64×128: one slot per
knot batch in the kernel's order (coverage, shape, detail; ``knot_group``
knots each), tiles row-major, the sky's slot empty.

The textures: the port's own bake at 16³ and 6×32² on the CPU, the shape
texture repeated to 64³ (nearest), so that the case whose shape texture
``chip_smoke.tex_envelope_scene`` enlarges 4× more per axis gets its
9-level pyramid.
"""

import pytest
import torch

import chip_smoke as cs
from godot_atmosphere_shader_tpu_torch.models.demo import bake_demo_textures
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

torch.set_num_threads(2)

H, W = 64, 128


@pytest.fixture(scope="module")
def textures():
    shape, cubemap = bake_demo_textures(device="cpu", shape_size=16, cubemap_size=32)
    for axis in range(3):
        shape = shape.repeat_interleave(4, axis)
    return shape, cubemap


def _recorded_choices(scene, cam):
    """``Scene.render``'s plain chain with the per-batch choices of every
    batched knot sampler call recorded, in call order: ``(B, 2)`` per
    call."""
    mk.counters.reset()
    with ts.record_batch_choices() as calls:
        scene.render(cam, H, W)
    assert mk.counters.plain_calls == 1
    return [torch.stack([mode, level], dim=-1) for mode, level in calls]


@pytest.mark.parametrize("case", list(cs.TEX_ENVELOPE_CASES))
def test_plain_tile_choices_are_the_plain_chains(textures, case):
    scene, cam = cs.tex_envelope_scene(cs.TEX_ENVELOPE_CASES[case], "cpu", textures)
    params, configs, tex, bands, rows = cs.scene_plan(scene, cam, H)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, bands=bands, band_rows=rows)
    calls = _recorded_choices(scene, cam)
    got = mk.tex_choices_plain(params[0], configs[0], cam, scene.opaque, H, W, tex[0])
    tiles, slots, _ = mk.tex_choice_shape(struct, args["tex"][0])
    assert tuple(got.shape) == (tiles, slots, 2) == ((H // 32) * (W // 128), 1 + len(calls), 2)
    assert (got[:, 0] == mk.NO_CHOICE).all()
    assert torch.equal(got[:, 1:].long(), torch.stack(calls, dim=1))
    modes = {ts.WINDOWED, ts.BANDED, ts.FLOOR}
    assert set(got[:, 1:, 0].unique().tolist()) <= modes
