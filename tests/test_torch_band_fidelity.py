"""Port vs JAX: the band-fidelity tool (``godot_atmosphere_shader_tpu_torch/
tools/measure_band_fidelity.py``) against ``tools/measure_band_fidelity.py``.

The JAX tool is imported from its file and not edited.  Its geometry bakes
the demo's 64³ shape field and 256² coverage cubemap first (~30 s in JAX
on the CPU; the port's CPU bake takes minutes, its card bake is what the
tool runs), and no figure compared here reads either: each package's bake
is replaced by the same seeded field for the test, given to the JAX scene
by patching the JAX bake functions and to the port's as its ``textures``.

* Geometry: the hit masks are equal; t0, t1 and the model-space origins and
  directions agree at rtol 1e-5, atol 1e-4 (measured: t0, origins 0; the
  directions 1.8e-7; t1 7.5e-5, about 2 ulps of t1, from the march span's
  cap, which JAX takes from host float64 scalars and the port from float32
  ones).
* The choice: the port's ``_tex3d_choice`` on the JAX tool's own planes
  gives ``_level_select``'s mode and level in every one of the 1530
  batches, and the port's own geometry gives the JAX tool's level counts.
* The samples: on the JAX tool's geometry the port cuts the JAX tool's
  planes bit for bit; its first two engaged batches through the port's
  plain ``sample_batches`` against the JAX sampler in an interpret-mode
  ``pl.pallas_call``, the JAX tool's harness, at K2's atol 2e-6, and the
  port's field-error figures on them against the JAX samples' (~25 s in
  all on one worker).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from godot_atmosphere_shader_tpu.ops import sampling as jsampling
from godot_atmosphere_shader_tpu.ops.pallas import texsample as jts
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as tts
from godot_atmosphere_shader_tpu_torch.tools import measure_band_fidelity as tool

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE = "interior"
# the JAX tool's level counts at the interior pose (PARITY #12: 484 of 1530
# batches restored to level 0); they depend on the geometry alone
WINDOWED = {"L1(32^3)": 4, "L2(16^3)": 378, "L3(8^3)": 32, "floor": 1116}
BANDED = {"L0(64^3)": 484, "L1(32^3)": 28, "floor": 1018}
FIELD_BATCHES = 2


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_band_fidelity", os.path.join(ROOT, "tools", "measure_band_fidelity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(16)
    return (rng.random((64, 64, 64)).astype(np.float32),
            rng.random((6, 16, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_side(fields):
    """The JAX tool, its geometry and its per-batch (mins, maxs, choice)
    as its ``run_fits`` computes them."""
    tex, cube = fields
    jbf = _jax_tool()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsampling, "bake_noise_texture3d", lambda *a, **k: jnp.asarray(tex))
        mp.setattr(jsampling, "bake_noise_cubemap", lambda *a, **k: jnp.asarray(cube))
        geom = jbf._batch_geometry(POSE)
    _, meta = jts.build_tex3d_pyramid(geom[-1])
    batches = []
    for _, hs, planes in jbf._iter_batches(*geom[:-1]):
        mins, maxs = np.full(3, np.inf), np.full(3, -np.inf)
        for pl3 in planes:
            for ax in range(3):
                f = pl3[ax] - np.floor(pl3[ax])
                mins[ax] = min(mins[ax], f[hs].min())
                maxs[ax] = max(maxs[ax], f[hs].max())
        batches.append((mins, maxs, jbf._level_select(mins, maxs, meta.levels)))
    return jbf, geom, meta, batches


@pytest.fixture(scope="module")
def port_geom(fields):
    tex, cube = fields
    return tool.batch_geometry(POSE, "cpu", textures=(torch.from_numpy(tex),
                                                      torch.from_numpy(cube)))


def _jax_choice(win, band, floor):
    """``_level_select``'s (windowed, banded) as the port's (mode, level)."""
    if band is not None and (win is None or band < win):
        return tts.BANDED, band
    return (tts.WINDOWED, win) if win is not None else (tts.FLOOR, floor)


def test_geometry_matches_the_jax_tool(jax_side, port_geom):
    _, (t0, t1, ro, rd, hit, scale, tex), _, _ = jax_side
    np.testing.assert_array_equal(port_geom.hit.numpy(), hit)
    assert port_geom.scale == scale and np.array_equal(port_geom.tex.numpy(), tex)
    pairs = [("t0", port_geom.t0, t0), ("t1", port_geom.t1, t1)]
    pairs += [(f"ro[{a}]", port_geom.ro[a], ro[a]) for a in range(3)]
    pairs += [(f"rd[{a}]", port_geom.rd[a], rd[a]) for a in range(3)]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4, err_msg=name)


def test_choice_on_the_jax_planes_equals_level_select(jax_side):
    """``_tex3d_choice`` (float32, as the kernels compare) on the JAX tool's
    extremes against ``_level_select`` (host float64), batch by batch."""
    _, _, meta, batches = jax_side
    tmeta = tts.TexMeta(**dataclasses.asdict(meta))
    mins = [torch.tensor([b[0][ax] for b in batches], dtype=torch.float32) for ax in range(3)]
    maxs = [torch.tensor([b[1][ax] for b in batches], dtype=torch.float32) for ax in range(3)]
    assert all(np.float32(m) == m for b in batches for m in (*b[0], *b[1]))
    floor = tmeta.floor_level(tool.WINDOW_ROWS)
    mode, level = tts._tex3d_choice(tmeta, mins, maxs, tool.WINDOW_ROWS, tool.BAND_ROWS,
                                    tool.BAND_MAX_SLICES)
    win_mode, win_level = tts._tex3d_choice(tmeta, mins, maxs, tool.WINDOW_ROWS, 0,
                                            tool.BAND_MAX_SLICES)
    assert len(batches) == 1530
    for i, (_, _, (win, band)) in enumerate(batches):
        assert (int(mode[i]), int(level[i])) == _jax_choice(win, band, floor), i
        assert (int(win_mode[i]), int(win_level[i])) == _jax_choice(win, None, floor), i


def test_level_counts_from_the_port_geometry_equal_the_jax_tool(jax_side, port_geom):
    _, _, meta, batches = jax_side
    labels = [f"L{i}({lv[0]}^3)" for i, lv in enumerate(meta.levels)] + ["floor"]
    n = len(meta.levels)
    win_c, eff_c = np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)
    for _, _, (win, band) in batches:
        win_c[n if win is None else win] += 1
        eff_c[band if band is not None and (win is None or band < win)
              else (n if win is None else win)] += 1
    jax_counts = ({lb: int(c) for lb, c in zip(labels, win_c) if c},
                  {lb: int(c) for lb, c in zip(labels, eff_c) if c})
    assert jax_counts == (WINDOWED, BANDED)
    fits = tool.run_fits(port_geom)
    assert (fits["windowed"], fits["banded"]) == jax_counts
    assert fits["batches"] == 1530 and "k2_full_batches" not in fits
    assert torch.equal(fits["index"], torch.arange(1530))
    for i, (_, _, (win, band)) in enumerate(batches):
        assert tuple(fits["choices"][i, 2:].tolist()) == _jax_choice(
            win, band, meta.floor_level(tool.WINDOW_ROWS)), i


def _jax_tex3d(data, meta, x, y, z, band_rows):
    """The JAX tool's ``run3d`` (``tools/measure_band_fidelity.py:175-184``)."""
    def kern(tab_ref, x_ref, y_ref, z_ref, o_ref):
        o_ref[:] = jts.sample_tex3d(tab_ref, meta, x_ref[:], y_ref[:], z_ref[:],
                                    window_rows=tool.WINDOW_ROWS, band_rows=band_rows)

    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True,
    )(jnp.asarray(data), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))


def test_engaged_batches_match_the_jax_sampler(jax_side):
    """On the JAX tool's geometry, the port's ``iter_batches`` (every pixel
    hit, in the JAX order) cuts the JAX tool's own planes, bit for bit; on
    its first engaged batches the port's plain K2 samples as the JAX sampler
    does in interpret mode, with ``band_rows`` 0 and 16, in the mode and at
    the level ``_level_select`` gives; and ``run_field_err``'s figures on
    them are those of the JAX samples against JAX's exact trilinear."""
    jbf, geom, meta, batches = jax_side
    t0, t1, ro, rd, hit, scale, tex = geom
    jgeom = tool.Geometry(torch.tensor(t0), torch.tensor(t1), tool.Vec3(*map(torch.tensor, ro)),
                          tool.Vec3(*map(torch.tensor, rd)), torch.tensor(hit), scale,
                          torch.tensor(tex))
    data = np.asarray(jts.build_tex3d_pyramid(tex)[0])
    table = torch.from_numpy(data)
    tmeta = tts.TexMeta(**dataclasses.asdict(meta))
    jplanes = [planes for _, _, planes in jbf._iter_batches(*geom[:-1], require_full=True)]
    assert len(jplanes) == len(batches)  # every pixel hits: the indices are the same
    found = []
    for b in tool.iter_batches(jgeom, require_full=True):
        if len(found) >= FIELD_BATCHES and tool.tile_row(b) > tool.tile_row(last):
            break  # a tile row's batches come before the next row's in the JAX order
        last = b
        off = mk.sample_batches(table, tmeta, b.x, b.y, b.z, tool.WINDOW_ROWS, 0)
        on = mk.sample_batches(table, tmeta, b.x, b.y, b.z, tool.WINDOW_ROWS, tool.BAND_ROWS)
        for j in (on[0] != off[0]).any(1).nonzero()[:, 0].tolist():
            found.append((int(b.index[j]), [c[j] for c in (b.x, b.y, b.z)], off[0][j], on[0][j],
                          (int(on[1][j]), int(on[2][j]))))
    found = sorted(found, key=lambda f: f[0])[:FIELD_BATCHES]
    assert len(found) == FIELD_BATCHES
    assert len({len(f[1][0]) for f in found}) == 2  # an 8-knot batch and a 1-knot one
    errs_w, errs_b = [], []
    for index, planes, off, on, choice in found:
        want = [np.concatenate([p[a] for p in jplanes[index]], 0).astype(np.float32)
                for a in range(3)]
        for a in range(3):
            np.testing.assert_array_equal(planes[a].reshape(want[a].shape).numpy(), want[a])
        j_off = _jax_tex3d(data, meta, *want, 0)
        j_on = _jax_tex3d(data, meta, *want, tool.BAND_ROWS)
        np.testing.assert_allclose(off.reshape(j_off.shape).numpy(), j_off, rtol=0, atol=2e-6)
        np.testing.assert_allclose(on.reshape(j_on.shape).numpy(), j_on, rtol=0, atol=2e-6)
        assert choice[0] == tts.BANDED and choice == _jax_choice(*batches[index][2], None)
        exact = np.asarray(jsampling.sample_trilinear_repeat(jnp.asarray(tex), *want))
        errs_w.append(np.abs(j_off - exact).ravel())
        errs_b.append(np.abs(j_on - exact).ravel())
    res = tool.run_field_err(jgeom, FIELD_BATCHES)
    assert res["engaged_batches"] == FIELD_BATCHES and "k2_vs_plain_max" not in res
    assert res["first_index"] == [f[0] for f in found]
    for name, errs in (("windowed", errs_w), ("banded", errs_b)):
        e = np.concatenate(errs)
        want = {"mean": e.mean(), "p99": np.percentile(e, 99), "max": e.max()}
        for k, v in want.items():
            assert abs(res[name][k] - v) <= 4e-6, (name, k, res[name][k], v)
