"""The Godot scene importer: the port's ``load_tscn`` against the JAX
package's on the same files, on the CPU.

The importer's test scene (``tests/test_tscn.py`` ``FIXTURE``) imports
field for field as JAX imports it: the configs, noise specs, node
properties and parameters, the ``OpaqueScene`` arrays (albedos from sRGB
within 1e-6), the ``skipped`` notes and the environment.  Its frame at
32×64 (8 march steps in both) matches the JAX XLA frame (run eagerly)
within the cloud tolerance (p99.9 |Δ| ≤ 1e-3, mean ≤ 1e-4, ≤ 0.1 % of
pixels above 1e-2), or, where one ulp of the camera moves the port's own
frame beyond it (measured first), the knot-group tolerance.  The scene
``chip_smoke.py`` imports at 1080p (12 spheres, 6 boxes, 10 octaves and
warp octaves) gives a launch struct whose inline entries and scene buffer
hold the geometry JAX's ``_build_values`` packs, and the octave
amplitudes of the noise specs.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import tscn as jtscn
from godot_atmosphere_shader_tpu.ops.pallas.megakernel import _build_values
from godot_atmosphere_shader_tpu.utils import camera as jcam
from godot_atmosphere_shader_tpu_torch.models import tscn as ttscn
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tests.test_tscn import FIXTURE  # noqa: E402

torch.set_num_threads(2)

EYE, TARGET = (0.0, 20.0, 160.0), (0.0, 0.0, 0.0)


@pytest.fixture
def eager_jax(monkeypatch):
    """The JAX package's XLA path run op by op (``jax.disable_jit``, a
    ``fori_loop`` that hands its body an int32 index, as traced)."""
    def fori_loop(lower, upper, body, init, **kwargs):
        val = init
        for i in range(int(lower), int(upper)):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _write(tmp_path, text, name="scene.tscn"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_fixture_is_the_importers_test_scene():
    assert cs.TSCN_FIXTURE == FIXTURE
    text = cs.tscn_fixture()
    sections = ttscn.parse_tscn(text)
    assert sections == jtscn.parse_tscn(text)
    meshes = [s for s in sections if s.get("type") == "MeshInstance3D"]
    assert len(meshes) == 1 + cs.TSCN_SPHERES + cs.TSCN_BOXES  # the meshless Sun too


@pytest.mark.parametrize("text", ["fixture", "large"])
@pytest.mark.parametrize("procedural", [True, False])
def test_import_matches_jax_field_for_field(tmp_path, text, procedural):
    path = _write(tmp_path, FIXTURE if text == "fixture" else cs.tscn_fixture())
    kw = {} if procedural else {"shape_texture_size": 8}
    if not procedural:
        # a small cubemap bake: the resolution is the file's
        path = _write(tmp_path, open(path).read().replace("resolution = 128", "resolution = 16"))
    ref = jtscn.load_tscn(path, procedural=procedural, **kw)
    got = ttscn.load_tscn(path, procedural=procedural, device="cpu", **kw)
    assert got.skipped == ref.skipped
    assert got.scene.device.type == "cpu" and got.scene.environment == ref.scene.environment
    assert len(got.scene.atmospheres) == len(ref.scene.atmospheres) == 1
    ja, ta = ref.scene.atmospheres[0], got.scene.atmospheres[0]
    assert dataclasses.asdict(ta.config) == dataclasses.asdict(ja.config)
    for name in ("planet_radius", "atmosphere_height", "clouds_rotation_speed",
                 "force_fullscreen", "name"):
        assert getattr(ta, name) == getattr(ja, name), name
    np.testing.assert_array_equal(ta.transform, ja.transform)
    np.testing.assert_array_equal(ta.sun.transform, ja.sun.transform)
    for uname in ta.get_property_list():
        uname = uname.split("/", 1)[1]
        want = ja.get_shader_parameter(uname)
        value = ta.get_shader_parameter(uname)
        if want is None:
            assert value is None, uname
            continue
        np.testing.assert_allclose(_host(value), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=uname)
    jo, to = ref.scene.opaque, got.scene.opaque
    for f in dataclasses.fields(to):
        want, value = getattr(jo, f.name), getattr(to, f.name)
        if want is None:
            assert value is None, f.name
            continue
        np.testing.assert_allclose(_host(value), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=f.name)


def test_fixture_frame_matches_jax(tmp_path, eager_jax):
    """Both imports with the march cut to 8 steps (as the envelope tests
    run the JAX frame eagerly), at 32×64 (the envelope tests' size: at
    32×48 the two ill-conditioned pixels below weigh 1/768 of the frame's
    mean).  The scene's ridged 6-octave
    cellular shape is ill-conditioned at a few cloud pixels: one ulp of the
    camera's position moves the port's own frame beyond the cloud
    tolerance (measured first, here).  Where it does, the frame is held to
    the knot-group tolerance instead (``chip_smoke.knot_group_tolerance_ok``:
    p99 ≤ 1e-3, mean ≤ 1e-4, ≤ 0.5 % of pixels above 1e-2), as the
    envelope tests do; where it does not, to the cloud tolerance."""
    path = _write(tmp_path, FIXTURE)
    h, w = 32, 64
    jscene = jtscn.load_tscn(path).scene
    tscene = ttscn.load_tscn(path, device="cpu").scene
    for a in (jscene.atmospheres[0], tscene.atmospheres[0]):
        a.set_custom_shader(dataclasses.replace(a.config, cloud_steps=8))
    jc = jcam.Camera.create(jcam.look_at(EYE, TARGET))
    jscene.update(0.0, jc)
    ref = jscene.render(jc, h, w, renderer="xla")
    ref = np.concatenate([np.asarray(ref["color"]), np.asarray(ref["alpha"])[..., None]], -1)
    m = look_at(EYE, TARGET, device="cpu").numpy()

    def frame(vtw):
        cam = Camera.create(vtw, device="cpu")
        tscene.update(0.0, cam)
        out = tscene.render(cam, h, w)
        return torch.cat([out["color"], out["alpha"][..., None]], -1).numpy()

    mk.counters.reset()
    got = frame(m)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    conditioned = True
    for axis, sign in cs.ULP_MOVES:
        moved = m.copy()
        moved[axis, 3] = np.nextafter(moved[axis, 3], np.float32(sign * np.inf))
        conditioned &= cs.cloud_tolerance_ok(cs.cloud_deltas(frame(moved), got))
    st = cs.cloud_deltas(got, ref)
    ok = cs.cloud_tolerance_ok if conditioned else cs.knot_group_tolerance_ok
    assert ok(st), (conditioned, st)


def _bounding(spec):
    """FastNoiseLite's fractal bounding, ``1 / Σ gainᵒ`` (JAX ops/noise.py)."""
    return 1.0 / sum(spec.gain ** o for o in range(spec.octaves))


def test_large_scene_struct_and_buffer_hold_jax_values(tmp_path):
    """12 spheres, 6 boxes, 10 octaves: the first 8 spheres and 4 boxes in
    the launch struct, the rest in the scene buffer it points to, in JAX's
    order; each noise spec's octaves past the struct's 8 there too."""
    path = _write(tmp_path, cs.tscn_fixture())
    jscene = jtscn.load_tscn(path).scene
    jc = jcam.Camera.create(jcam.look_at(EYE, TARGET))
    jscene.update(0.0, jc)
    jatmo = jscene.atmospheres[0]
    values = _build_values(jatmo.build_params(), jc, jscene.opaque, cs.TSCN_SPHERES,
                           cs.TSCN_BOXES)
    tscene = ttscn.load_tscn(path, device="cpu").scene
    tc = Camera.create(look_at(EYE, TARGET, device="cpu"), device="cpu")
    tscene.update(0.0, tc)
    _, params, configs = tscene._sorted_layers(tc)
    s = mk.frame_constants(params[0], configs[0], tc, tscene.opaque, 64, 96)
    assert (s.n_spheres, s.n_boxes) == (mk.INLINE_SPHERES, mk.INLINE_BOXES)
    assert (s.n_spheres + s.ext_spheres, s.n_boxes + s.ext_boxes) == (cs.TSCN_SPHERES,
                                                                      cs.TSCN_BOXES)
    lay = mk.scene_layout(s)
    buf = next(t for _, _, t in mk._SCENE_BUFFERS.values() if t.data_ptr() == s.geom).numpy()
    ni, nb = mk.INLINE_SPHERES, mk.INLINE_BOXES
    at, n = lay["spheres"]
    extra = buf[at:at + n].reshape(-1, mk.GEOM_SPHERE)
    centers = np.concatenate([np.ctypeslib.as_array(s.sphere_center).reshape(ni, 3),
                              extra[:, 0:3]])
    radius2 = np.concatenate([np.ctypeslib.as_array(s.sphere_radius2), extra[:, 3]])
    albedos = np.concatenate([np.ctypeslib.as_array(s.sphere_albedo).reshape(ni, 3),
                              extra[:, 4:7]])
    unshaded = np.concatenate([np.ctypeslib.as_array(s.sphere_unshaded), extra[:, 7]])
    radii = np.asarray(values["sphere_radii"])
    np.testing.assert_array_equal(centers, np.asarray(values["sphere_centers"]))
    np.testing.assert_array_equal(radius2, radii * radii)
    np.testing.assert_allclose(albedos, np.asarray(values["sphere_albedos"]), rtol=1e-6)
    np.testing.assert_array_equal(unshaded, np.asarray(values["sphere_unshaded"]))
    at, n = lay["boxes"]
    extra = buf[at:at + n].reshape(-1, mk.GEOM_BOX)
    np.testing.assert_array_equal(
        np.concatenate([np.ctypeslib.as_array(s.box_w2b).reshape(nb, 16), extra[:, :16]]),
        np.asarray(values["box_world_to_box"]).reshape(-1, 16))
    np.testing.assert_array_equal(
        np.concatenate([np.ctypeslib.as_array(s.box_half).reshape(nb, 3), extra[:, 16:19]]),
        np.asarray(values["box_half_sizes"]))
    np.testing.assert_array_equal(
        np.concatenate([np.ctypeslib.as_array(s.box_albedo).reshape(nb, 3), extra[:, 19:22]]),
        np.asarray(values["box_albedos"]))
    # the octaves: the struct's 8, then the buffer's, on the JAX amplitude chains
    for name, field in (("shape", jatmo.config.cloud_shape_noise),
                        ("coverage", jatmo.config.cloud_coverage_noise)):
        spec, struct = field.noise, getattr(s, name)
        octaves = max(spec.octaves, spec.warp_octaves)
        assert octaves == cs.TSCN_OCTAVES and struct.ext
        warp = spec.warp_octaves if spec.warp_enabled else 0
        assert (struct.octaves, struct.ext_octaves, struct.warp_octaves,
                struct.ext_warp_octaves) == (min(spec.octaves, 8), max(spec.octaves - 8, 0),
                                             min(warp, 8), max(warp - 8, 0))
        at, n = lay[name]
        assert struct.ext == s.geom + 4 * at and n == 3 * (octaves - mk.INLINE_OCTAVES)
        ext = buf[at:at + n].reshape(-1, mk.EXT_OCTAVE)
        amp = [_bounding(spec) * spec.gain ** o for o in range(spec.octaves)]
        wa = [spec.warp_amplitude * spec.warp_gain ** o for o in range(spec.warp_octaves)]
        wf = [spec.warp_frequency * spec.warp_lacunarity ** o for o in range(spec.warp_octaves)]
        got_amp = np.concatenate([np.ctypeslib.as_array(struct.amp), ext[:, 0]])
        np.testing.assert_allclose(got_amp[:spec.octaves], amp, rtol=1e-6)
        if spec.warp_enabled:
            np.testing.assert_allclose(
                np.concatenate([np.ctypeslib.as_array(struct.warp_amp), ext[:, 1]])[:len(wa)],
                wa, rtol=1e-6)
            np.testing.assert_allclose(
                np.concatenate([np.ctypeslib.as_array(struct.warp_freq), ext[:, 2]])[:len(wf)],
                wf, rtol=1e-6)
    # the buffer is cached per opaque scene: the next frame's struct points at it
    again = mk.frame_constants(params[0], configs[0], tc, tscene.opaque, 64, 96)
    assert again.geom == s.geom
