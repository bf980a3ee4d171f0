"""The TAA resolve (K3): the plain version against JAX ``taa_resolve``.

The same seeded numpy planes and camera matrices go through the JAX kernel
in interpret mode (as ``tests/test_taa.py`` runs it on the CPU) and through
the port's ``taa_resolve`` on CPU tensors (its plain version).  Tolerance:
atol 1e-5 on the resolved colour.  XLA may contract the JAX kernel's
multiply-adds where the port rounds each operation, so reprojected
coordinates differ by a few ulps (~1e-5 px at 128 px); the planes are smooth
(≤ 0.1 per pixel), which keeps that below 1e-6 in value, and the camera
motions put no pixel on a validity threshold, where an ulp would flip it (a
flip shows as ~0.1).  The identity camera is the exception: it reprojects
the frame's border rows and columns exactly onto the frame's edge, so there
validity is decided by rounding and only the interior is compared.  The
depth output must be equal.  Also: the launch struct and launcher signature
against ``csrc/taa.cu``.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.ops.pallas.taa import taa_resolve as jax_taa_resolve
from godot_atmosphere_shader_tpu.utils.camera import Camera as JaxCamera
from godot_atmosphere_shader_tpu_torch.ops.kernels import library
from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

torch.set_num_threads(2)

ATOL = 1e-5


def _field(h, w, rng, cell=16):
    """A smooth random field in [0, 1): values on a ``cell``-pixel lattice,
    interpolated bilinearly."""
    g = rng.random((h // cell + 2, w // cell + 2))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    rows = np.stack([np.interp(xs, np.arange(g.shape[1]), r) for r in g])
    return np.stack([np.interp(ys, np.arange(g.shape[0]), c) for c in rows.T], axis=1)


def _smooth(h, w, seed):
    """Smooth colour plus fine noise (≤ 0.1 per pixel), so that the 3×3
    clamp bites on some pixels and not on others."""
    rng = np.random.default_rng(seed)
    img = _field(h, w, rng)
    img = np.stack([img, img * 0.5 + 0.2, 1.0 - img], -1)
    return (img + 0.01 * rng.random((h, w, 3))).astype(np.float32)


def _pose(eye, yaw=0.0, pitch=0.0):
    """A view→world matrix (float32) at ``eye`` looking down −Z turned by
    ``yaw`` about +Y and ``pitch`` about +X."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    m = np.eye(4)
    m[:3, :3] = ry @ rx
    m[:3, 3] = eye
    return m.astype(np.float32)


def _depth(h, w, seed, near=20.0, far=80.0):
    return (near + (far - near) * _field(h, w, np.random.default_rng(seed))).astype(np.float32)


# name: (height, width, prev pose, cur pose, blend, depth seed/planes, kwargs)
CASES = {
    # no sky here: next to it an ulp of weight on 1e7 decides depth validity
    "identity": dict(hw=(64, 128), prev=_pose((0, 0, 0)), cur=_pose((0, 0, 0)), blend=0.25,
                     sky=False),
    "sideways_shift": dict(hw=(64, 128), prev=_pose((0.8, 0.05, 0)), cur=_pose((0, 0, 0)),
                           blend=0.1),
    "turn_and_climb": dict(hw=(64, 128), prev=_pose((0.2, 0.0, 0.5), yaw=0.02),
                           cur=_pose((0, 0.3, 0), pitch=-0.01), blend=0.3),
    # 96×512: the 64×384 window is smaller than the frame; near pixels
    # (depth 0.5) move by hundreds of pixels, far ones barely, so a tile's
    # footprint leaves its window
    "window_exit": dict(hw=(96, 512), prev=_pose((1.0, 0.1, 0)), cur=_pose((0, 0, 0)),
                        blend=0.2, near_far=(0.5, 60.0), depth_eps=1e6),
    # 72 rows: the last 32-row tile holds 8 frame rows and 24 pad rows
    "partial_tile": dict(hw=(72, 128), prev=_pose((0.5, -0.4, 0)), cur=_pose((0, 0, 0.3)),
                         blend=0.2),
    "disocclusion": dict(hw=(64, 128), prev=_pose((0.5, 0.07, 0)), cur=_pose((0, 0, 0)),
                         blend=0.2, occluder=True),
    "no_history_depth": dict(hw=(64, 128), prev=_pose((0.5, 0.2, 0)), cur=_pose((0, 0, 0)),
                             blend=0.2, history_depth=False),
    "variance": dict(hw=(64, 128), prev=_pose((0.6, 0.1, 0)), cur=_pose((0, 0, 0)),
                     blend=0.15, clamp_mode="variance", clamp_gamma=1.0),
}


def _inputs(name):
    c = CASES[name]
    h, w = c["hw"]
    seed = sum(map(ord, name))
    cur = _smooth(h, w, seed)
    hist = _smooth(h, w, seed + 1)
    near, far = c.get("near_far", (20.0, 80.0))
    if "near_far" in c:
        ld = np.where(_depth(h, w, seed + 2) < 50.0, near, far).astype(np.float32)
    else:
        ld = _depth(h, w, seed + 2)
    if c.get("sky", True):
        ld[4:8, 8:16] = 1.0e7 * 3  # a few sky pixels above the 1e7 clamp
    hd = ld.copy()
    if c.get("occluder"):
        hd[16:48, 32:96] *= 3.0  # last frame saw something farther there
    kw = dict(depth_eps=c.get("depth_eps", 0.2), clamp_mode=c.get("clamp_mode", "minmax"),
              clamp_gamma=c.get("clamp_gamma", 1.25))
    return c, cur, ld, hist, (hd if c.get("history_depth", True) else None), kw


def _jax(c, cur, ld, hist, hd, kw):
    h, w = c["hw"]
    prev, now = (JaxCamera.create(jnp.asarray(c[k])) for k in ("prev", "cur"))
    out, depth = jax_taa_resolve(jnp.asarray(cur), jnp.asarray(ld), jnp.asarray(hist), prev, now,
                                 c["blend"], h, w, interpret=True,
                                 history_depth=None if hd is None else jnp.asarray(hd), **kw)
    return np.asarray(out), np.asarray(depth)


def _port(c, cur, ld, hist, hd, kw):
    h, w = c["hw"]
    prev, now = (Camera.create(c[k], device="cpu") for k in ("prev", "cur"))
    t = torch.from_numpy
    out, depth = taa.taa_resolve_plain(t(cur), t(ld), t(hist), prev, now, c["blend"], h, w,
                                       history_depth=None if hd is None else t(hd), **kw)
    return out.numpy(), depth.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    args = _inputs(name)
    ref, ref_depth = _jax(*args)
    taa.counters.reset()
    got, got_depth = _port(*args)
    assert taa.counters.plain_calls == 1 and taa.counters.launches == 0
    assert got.shape == ref.shape and np.isfinite(got).all()
    if name == "identity":  # the border reprojects exactly onto the frame edge
        got, ref = got[1:-1, 1:-1], ref[1:-1, 1:-1]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_depth, ref_depth)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    c, cur, ld, hist, hd, kw = _inputs("sideways_shift")
    h, w = c["hw"]
    prev, now = (Camera.create(c[k], device="cpu") for k in ("prev", "cur"))
    t = torch.from_numpy
    taa.counters.reset()
    got = taa.taa_resolve(t(cur), t(ld), t(hist), prev, now, c["blend"], h, w, t(hd), **kw)
    assert (taa.counters.plain_calls, taa.counters.launches) == (1, 0)
    ref = _port(c, cur, ld, hist, hd, kw)
    assert all(np.array_equal(g.numpy(), r) for g, r in zip(got, ref))


def _valid(name, **change):
    c, cur, ld, hist, hd, kw = _inputs(name)
    h, w = c["hw"]
    prev, now = (Camera.create(c[k], device="cpu") for k in ("prev", "cur"))
    p = taa.taa_constants(prev, now, c["blend"], h, w, h, **kw)
    for k, v in change.items():
        setattr(p, k, v)
    t = torch.from_numpy
    return taa.resolve_plain(p, t(cur), t(ld), t(hist), t(ld if hd is None else hd))[2]


def test_cases_exercise_their_rules():
    """Each rule decides some pixels: the window (a whole-frame window
    would admit more), disocclusion, and motion out of the frame."""
    valid = _valid("window_exit")
    wider = _valid("window_exit", win_rows=96, win_cols=512)
    assert int((wider & ~valid).sum()) > 100 and bool(valid.any())
    occ = _valid("disocclusion")
    assert not bool(occ[20:44, 40:88].any()) and float(occ[8:56, 100:].float().mean()) > 0.9
    assert not bool(_valid("sideways_shift").all())


# -- band mode: one row shard's rows against its halo'd history band ---------------


BAND_H, BAND_ROWS, HALO = 128, 32, 32


def _band_case():
    """``tests/test_sharding_taa.py:34-63``: blocky planes at depth 50, the
    camera moved by (0, 0.1, 0.2); 32-row shards whose history bands carry
    32 halo rows, zeros past the frame's edges."""
    def blocky(seed):
        g = np.random.default_rng(seed).random((BAND_H // 8 + 2, BAND_H // 8 + 2))
        img = np.kron(g, np.ones((8, 8)))[:BAND_H, :BAND_H]
        return np.stack([img, img * 0.5 + 0.2, 1.0 - img], -1).astype(np.float32)

    prev = _look((0.0, 0.1, 0.2), (0.0, 0.0, -1.0))
    cur = _look((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))
    depth = np.full((BAND_H, BAND_H), 50.0, np.float32)
    return blocky(1), depth, blocky(2), prev, cur


def _look(eye, target):
    from godot_atmosphere_shader_tpu_torch.utils.camera import look_at

    return look_at(eye, target, device="cpu").numpy().astype(np.float32)


def _bands(cur, depth, hist):
    """Per shard: (row0, its rows, its history band, its history depth band)."""
    pad = lambda a: np.concatenate([np.zeros((HALO,) + a.shape[1:], a.dtype), a,  # noqa: E731
                                    np.zeros((HALO,) + a.shape[1:], a.dtype)])
    hp, dp = pad(hist), pad(depth)
    for r0 in range(0, BAND_H, BAND_ROWS):
        yield (r0, cur[r0:r0 + BAND_ROWS], depth[r0:r0 + BAND_ROWS],
               hp[r0:r0 + BAND_ROWS + 2 * HALO], dp[r0:r0 + BAND_ROWS + 2 * HALO])


def test_band_mode_reassembles_the_full_frame_bit_for_bit():
    cur, depth, hist, prev, now = _band_case()
    t = torch.from_numpy
    cams = [Camera.create(m, device="cpu") for m in (prev, now)]
    full, full_depth = taa.taa_resolve(t(cur), t(depth), t(hist), *cams, 0.25, BAND_H, BAND_H,
                                       history_depth=t(depth))
    bands, depths = [], []
    for r0, c, d, hb, db in _bands(cur, depth, hist):
        out, dout = taa.taa_resolve(t(c), t(d), t(hb), *cams, 0.25, BAND_H, BAND_H,
                                    history_depth=t(db), row0=r0, hist_row0=r0 - HALO)
        bands.append(out)
        depths.append(dout)
    assert torch.equal(torch.cat(bands), full)
    assert torch.equal(torch.cat(depths), full_depth)
    p = taa.taa_constants(*cams, 0.25, BAND_H, BAND_H, BAND_ROWS + 2 * HALO, rows=BAND_ROWS,
                          row0=64, hist_row0=64 - HALO)
    assert (p.rows, p.row0, p.hist_rows, p.hist_row0, p.win_rows) == (32, 64, 96, 32, 64)


def test_band_mode_matches_jax():
    cur, depth, hist, prev, now = _band_case()
    jcams = [JaxCamera.create(jnp.asarray(m)) for m in (prev, now)]
    cams = [Camera.create(m, device="cpu") for m in (prev, now)]
    t = torch.from_numpy
    for r0, c, d, hb, db in _bands(cur, depth, hist):
        ref, ref_depth = jax_taa_resolve(jnp.asarray(c), jnp.asarray(d), jnp.asarray(hb), *jcams,
                                         0.25, BAND_H, BAND_H, interpret=True,
                                         history_depth=jnp.asarray(db), row0=float(r0),
                                         hist_row0=float(r0 - HALO))
        got, got_depth = taa.taa_resolve_plain(t(c), t(d), t(hb), *cams, 0.25, BAND_H, BAND_H,
                                               history_depth=t(db), row0=r0,
                                               hist_row0=r0 - HALO)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got_depth.numpy(), np.asarray(ref_depth))


@pytest.mark.parametrize("rows,hist_rows,width,mode", [
    (60, 64, 128, "minmax"), (64, 60, 128, "minmax"), (64, 64, 100, "minmax"),
    (64, 64, 128, "bogus")])
def test_refusals_match_jax(rows, hist_rows, width, mode):
    z = np.zeros
    cam = _pose((0, 0, 0))
    with pytest.raises(ValueError):
        jax_taa_resolve(jnp.asarray(z((rows, width, 3), np.float32)),
                        jnp.asarray(z((rows, width), np.float32)),
                        jnp.asarray(z((hist_rows, width, 3), np.float32)),
                        JaxCamera.create(jnp.asarray(cam)), JaxCamera.create(jnp.asarray(cam)),
                        0.5, rows, width, interpret=True, clamp_mode=mode)
    port_cam = Camera.create(cam, device="cpu")
    with pytest.raises(ValueError):
        taa.taa_resolve(torch.zeros((rows, width, 3)), torch.zeros((rows, width)),
                        torch.zeros((hist_rows, width, 3)), port_cam, port_cam, 0.5, rows,
                        width, clamp_mode=mode)


# -- the CUDA source and its ctypes binding ------------------------------------


def _source(name):
    with open(next(s for s in library.SOURCES if s.endswith(name))) as f:
        return f.read()


def test_cu_struct_matches_ctypes_mirror():
    body = re.search(r"struct TaaParams \{(.*?)\n\};", _source("taa.cu"), re.S).group(1)
    want = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            ctype, fname, n = re.fullmatch(r"(int|float) (\w+)(?:\[(\d+)\])?;", line).groups()
            t = ctypes.c_int if ctype == "int" else ctypes.c_float
            want.append((fname, t if n is None else t * int(n)))
    got = list(taa.TaaParams._fields_)
    assert [f for f, _ in got] == [f for f, _ in want]
    for (fname, t_got), (_, t_want) in zip(got, want):
        assert t_got == t_want or (t_got._type_ == t_want._type_
                                   and t_got._length_ == t_want._length_), fname


@pytest.mark.parametrize("source,name,argtypes", [
    ("taa.cu", "taa_launch", taa.LAUNCHER_ARGTYPES),
    ("taa.cu", "taa_info", taa.INFO_ARGTYPES),
    ("probes.cu", "fill_launch", None)])
def test_cu_launcher_signature_matches_argtypes(source, name, argtypes):
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    argtypes = argtypes or probes.FILL_ARGTYPES
    sig = re.search(r'extern "C" int %s\((.*?)\)' % name, _source(source), re.S).group(1)
    params = [" ".join(p.split()).rsplit(" ", 1)[0] for p in sig.split(",")]
    c = {"int": ctypes.c_int, "float": ctypes.c_float,
         "const TaaParams*": ctypes.POINTER(taa.TaaParams)}
    assert argtypes == tuple(c.get(p, ctypes.c_void_p) for p in params), params


def _taa_terms():
    """The source's ``TAA_*`` defines and its ``constexpr int TAA_*``
    constants evaluated from them."""
    src = _source("taa.cu")
    terms = {k: int(v) for k, v in re.findall(r"#define (TAA_\w+) (\d+)", src)}
    for name, expr in re.findall(r"constexpr int (TAA_\w+) = (.*?);", src):
        terms[name] = eval(expr.replace("/", "//"), {}, terms)
    return terms


def test_cu_layout_matches_wrapper():
    """The tile, the CTAs of its cluster, a CTA's threads and the resident
    CTAs per SM its registers are sized for, as the wrapper mirrors them."""
    defines = {k: int(v) for k, v in re.findall(r"#define (TAA_\w+) (\d+)", _source("taa.cu"))}
    assert defines == {"TAA_TILE_ROWS": taa.TILE_ROWS, "TAA_TILE_COLS": taa.TILE_COLS,
                       "TAA_CTAS": taa.CTAS, "TAA_THREADS_Y": taa.THREADS_Y,
                       "TAA_MIN_BLOCKS": taa.MIN_BLOCKS}


def test_cu_shared_memory_matches_wrapper():
    """A CTA's dynamic shared memory (``taa_smem_bytes``, evaluated from the
    source) equals the wrapper's ``smem_bytes``; a CTA is whole rows of the
    tile and a thread whole rows of the CTA; MIN_BLOCKS CTAs fit an SM's
    228 KB (1 KB reserved per CTA)."""
    terms = _taa_terms()
    expr = re.search(r"constexpr int taa_smem_bytes\(\) \{\s*return (.*?);\s*\}",
                     _source("taa.cu"), re.S).group(1)
    smem = eval(" ".join(expr.split()).replace("(int)sizeof(float)", "4").replace("/", "//"),
                {}, terms)
    assert smem == taa.smem_bytes()
    assert terms["TAA_CTA_ROWS"] * taa.CTAS == taa.TILE_ROWS
    assert terms["TAA_ROWS_PER_THREAD"] * taa.THREADS_Y == terms["TAA_CTA_ROWS"]
    assert taa.MIN_BLOCKS * (smem + 1024) <= 233472


def test_cu_launcher_launches_a_cluster_per_tile():
    """``taa_launch`` launches TAA_CTAS CTAs per 32×128 tile along y, as a
    cluster of (1, TAA_CTAS, 1), with the kernel's dynamic shared memory;
    ``taa_info`` queries the same configuration."""
    src = _source("taa.cu")
    launch = re.search(r'extern "C" int taa_launch\(.*?\n\}', src, re.S).group(0)
    assert "(p.rows + TAA_TILE_ROWS - 1) / TAA_TILE_ROWS * TAA_CTAS" in launch
    assert "cudaLaunchKernelEx(&launch.cfg, taa_kernel" in launch
    config = re.search(r"struct TaaLaunch \{.*?\n\};", src, re.S).group(0)
    for line in ("cfg.blockDim = dim3(TAA_TILE_COLS, TAA_THREADS_Y, 1);",
                 "cfg.dynamicSmemBytes = (size_t)taa_smem_bytes();",
                 "attr[0].val.clusterDim.y = TAA_CTAS;", "cfg.numAttrs = 1;"):
        assert line in config
    info = re.search(r'extern "C" int taa_info\(.*?\n\}', src, re.S).group(0)
    assert "TaaLaunch launch(" in info and "taa_smem_bytes()" in info
