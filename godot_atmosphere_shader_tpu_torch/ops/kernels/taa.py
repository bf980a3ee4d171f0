"""The TAA resolve (K3): wrapper, plain version and launcher.

Counterpart of ``godot_atmosphere_shader_tpu/ops/pallas/taa.py``: each
output frame blends the current render with the previous *resolved* frame,
reprojected through the camera motion.  Per 32×128 tile: world positions
from the current linear depth, projection into the previous camera,
validity (in front of the camera, inside the frame, inside the tile's
64×384 history window, and history depth within ``depth_eps``), bilinear
history, a 3×3 tile-local neighbourhood clamp (``"minmax"`` box or
``"variance"`` μ ± γσ), and the blend.  Band mode (row sharding,
``parallel/sharding.py``): the current planes may be one shard's rows of a
taller frame, from global row ``row0``, against a history band whose first
row is global row ``hist_row0`` (the shard's rows and a halo above and
below); pixels keep their global rows for the projection and the frame's
bounds, the pad rows are those past the shard's own rows, and the window
and the bilinear read address the history band.  A full frame is the band
``row0 = hist_row0 = 0``.

* :func:`taa_resolve` is the wrapper: CPU tensors take the plain version
  (:func:`taa_resolve_plain`), CUDA tensors launch ``csrc/taa.cu`` (built
  at first use with the other kernels, ``library.py``) or raise.  Nothing
  falls back.
* :func:`resolve_plain` is the plain PyTorch version on a launch struct
  (:func:`taa_constants`, the counterpart of ``_pack_taa_scalars``); it
  runs on any device and is what the kernel is held against.
* :func:`launch` is one kernel launch on a prepared struct into
  preallocated outputs (the flight's loop uses it).
* :data:`counters` counts kernel launches and plain calls.
* :func:`info` says what the kernel uses on the card (:data:`INFO`).

The TPU kernel copies a 64×384 history window per tile because the TPU
cannot gather; the window's base (a tile-wide min of the reprojected
coordinates, aligned to 8 rows and 128 columns) and its validity rule are
kept exactly, since they decide the result, while both versions read the
history directly.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ...utils.camera import Camera, ray_scale, rigid_inverse, transform_dir, transform_point
from ...utils.profiling import span
from ...utils.vecmath import Vec3
from . import library

#: the TPU kernel's history window (rows aligned to 8, columns to 128)
WIN_ROWS = 64
WIN_COLS = 384
TILE_ROWS, TILE_COLS = 32, 128
#: the kernel's layout (``TAA_*`` of ``csrc/taa.cu``): a tile is a cluster of
#: CTAS CTAs of 128 × THREADS_Y threads, each CTA ``TILE_ROWS // CTAS`` of
#: its rows, registers sized for MIN_BLOCKS resident CTAs per SM
CTAS = 2
THREADS_Y = 4
MIN_BLOCKS = 3
#: what :func:`info` reports
INFO = ("ctas_per_tile", "threads", "registers", "stack_bytes", "blocks_per_sm", "smem_bytes",
        "clusters")
CLAMP_MODES = ("minmax", "variance")
#: sky's linear depth is clamped here before the reprojection
DEPTH_CLAMP = 1.0e7


def _floats(n):
    return ctypes.c_float * n


class TaaParams(ctypes.Structure):
    """Mirror of ``struct TaaParams`` in ``csrc/taa.cu``."""

    _fields_ = [
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("hist_rows", ctypes.c_int),
        ("hist_row0", ctypes.c_int),
        ("win_rows", ctypes.c_int),
        ("win_cols", ctypes.c_int),
        ("variance", ctypes.c_int),
        ("w2v_prev", _floats(16)),
        ("rot", _floats(9)),
        ("pos", _floats(3)),
        ("sx_cur", ctypes.c_float),
        ("sy_cur", ctypes.c_float),
        ("sx_prev", ctypes.c_float),
        ("sy_prev", ctypes.c_float),
        ("blend", ctypes.c_float),
        ("depth_eps", ctypes.c_float),
        ("clamp_gamma", ctypes.c_float),
    ]


#: ``taa_launch``'s and ``taa_info``'s C signatures, as the ctypes binding
#: declares them
LAUNCHER_ARGTYPES = (ctypes.POINTER(TaaParams), *(ctypes.c_void_p,) * 8)
INFO_ARGTYPES = (ctypes.c_void_p,)


def smem_bytes() -> int:
    """A CTA's dynamic shared memory (``taa_smem_bytes``): its rows' current
    rgb with the tile's row above and below them, its output rgb, and the
    min's scratch (2 floats per warp and the CTA's 2)."""
    rows, row_floats = TILE_ROWS // CTAS, TILE_COLS * 3
    return ((rows + 2) * row_floats + rows * row_floats + 2 * (TILE_COLS * THREADS_Y // 32)
            + 2) * 4


class Counters:
    """Kernel launches and plain-version calls of the resolve."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0
        self.plain_calls = 0


counters = Counters()


@dataclasses.dataclass(frozen=True)
class TaaSettings:
    """A TAA flight's resolve settings (``Scene.render_flight``'s
    ``taa_*`` arguments)."""

    blend: float = 0.15
    depth_eps: float = 0.2
    clamp_mode: str = "minmax"
    clamp_gamma: float = 1.25


def check_shapes(rows: int, hist_rows: int, width: int, clamp_mode: str):
    """The JAX kernel's refusals: the clamp mode, and shapes off its DMA
    tiling (rows % 8, width % 128)."""
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp_mode {clamp_mode!r}")
    if rows % 8 or width % 128 or hist_rows % 8 or rows < 8 or hist_rows < 8 or width < 128:
        raise ValueError("taa_resolve needs rows % 8 == 0 (both current and history) "
                         f"and width % 128 == 0 (DMA tile alignment); got "
                         f"{rows}/{hist_rows} x {width}")


def _host(t: torch.Tensor) -> torch.Tensor:
    with span("port.copy.taa_camera", t.device):
        return t.detach().to("cpu", torch.float32)


def _row(v) -> int:
    """A band offset (JAX passes it as a float): a whole number of rows."""
    if float(v) != int(v):
        raise ValueError(f"row offsets are whole rows, got {v}")
    return int(v)


def taa_constants(cam_prev: Camera, cam_cur: Camera, blend, height: int, width: int,
                  hist_rows: int, depth_eps=0.2, clamp_mode: str = "minmax",
                  clamp_gamma=1.25, rows=None, row0=0, hist_row0=0) -> TaaParams:
    """The resolve's launch struct, computed on the host: the previous
    camera's world→view, the current camera's rotation and position, both
    ray preambles (``utils/camera.py::ray_scale``), the window and the
    settings.  ``height``/``width`` are the whole frame's; band mode:
    ``rows`` current rows (default ``height``) from global row ``row0``,
    the history's ``hist_rows`` rows from global row ``hist_row0``."""
    rows = height if rows is None else rows
    check_shapes(rows, hist_rows, width, clamp_mode)
    prev = _host(cam_prev.view_to_world)
    cur = _host(cam_cur.view_to_world)
    s = TaaParams()
    s.height, s.width, s.hist_rows = height, width, hist_rows
    s.rows, s.row0, s.hist_row0 = rows, _row(row0), _row(hist_row0)
    s.win_rows = min(WIN_ROWS, hist_rows // 8 * 8)
    s.win_cols = min(WIN_COLS, width // 128 * 128)
    s.variance = int(clamp_mode == "variance")
    s.w2v_prev[:] = rigid_inverse(prev).reshape(-1).tolist()
    s.rot[:] = cur[:3, :3].reshape(-1).tolist()
    s.pos[:] = cur[:3, 3].tolist()
    s.sx_cur, s.sy_cur = ray_scale(cam_cur, height, width)
    s.sx_prev, s.sy_prev = ray_scale(cam_prev, height, width)
    s.blend, s.depth_eps, s.clamp_gamma = float(blend), float(depth_eps), float(clamp_gamma)
    return s


def _per_tile(t: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """``(rows, width)`` → ``(tile rows, 32, tile cols, 128)``."""
    return t.reshape(rows // TILE_ROWS, TILE_ROWS, width // TILE_COLS, TILE_COLS)


def _per_pixel(t: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """One value per tile → ``(rows, width)``."""
    ty, tx = t.shape
    return t[:, None, :, None].expand(ty, TILE_ROWS, tx, TILE_COLS).reshape(rows, width)


def _lerp(v0, v1, w):
    return v0 * (1.0 - w) + v1 * w


def resolve_plain(p: TaaParams, cur: torch.Tensor, linear_depth: torch.Tensor,
                  history: torch.Tensor, history_depth: torch.Tensor) -> tuple:
    """The plain PyTorch resolve on launch struct ``p``: ``cur`` (R, W, 3),
    ``linear_depth`` (R, W), ``history`` (Hh, W, 3), ``history_depth``
    (Hh, W), all on one device (R = ``p.rows``, the whole frame's height
    outside band mode).  Returns ``(resolved (R, W, 3), depth (R, W), valid
    (R, W) bool)``; ``depth`` is ``min(linear_depth, 1e7)``, the next
    frame's history depth.  Works on the tile-padded grid (pad rows, past
    the band's own rows, take depth 1.0 and count in the window base, as on
    the TPU)."""
    dev = cur.device
    f32 = dict(dtype=torch.float32, device=dev)
    height, width, hist_rows = p.height, p.width, p.hist_rows
    rows = -(-p.rows // TILE_ROWS) * TILE_ROWS
    pad = rows - p.rows
    local = torch.arange(rows, **f32)
    # global rows (taa.py:75-76); the pad bound is the band's own extent,
    # not the frame's (taa.py:89-95)
    iy = (local + float(p.row0))[:, None].expand(rows, width)
    ix = torch.arange(width, **f32)[None, :].expand(rows, width)
    in_frame = (local < p.rows)[:, None].expand(rows, width)

    # ---- reprojection into the previous camera.  Divisors are tensors on
    # the device and the normalisation is 1 / sqrt: on a card, PyTorch
    # divides by a host scalar through its reciprocal and its rsqrt is not
    # correctly rounded, while the kernel rounds every division once ----
    def scalar(v):
        return torch.tensor(float(v), **f32)

    ndc_x = 2.0 * (ix[0] + 0.5) / scalar(width) - 1.0
    ndc_y = 1.0 - 2.0 * (iy[:, 0] + 0.5) / scalar(height)
    dv = Vec3((ndc_x * p.sx_cur).expand(rows, width),
              (ndc_y * p.sy_cur)[:, None].expand(rows, width),
              torch.full((rows, width), -1.0, **f32))
    inv = 1.0 / torch.sqrt(dv.x * dv.x + dv.y * dv.y + dv.z * dv.z)
    dv = Vec3(dv.x * inv, dv.y * inv, dv.z * inv)
    rot = [[p.rot[3 * i + j] for j in range(3)] for i in range(3)]
    d = transform_dir(rot, dv)
    ld = torch.cat([linear_depth, torch.ones((pad, width), **f32)])
    ld = torch.clamp(ld, max=DEPTH_CLAMP)
    world = Vec3(p.pos[0] + d.x * ld, p.pos[1] + d.y * ld, p.pos[2] + d.z * ld)
    w2v = [[p.w2v_prev[4 * i + j] for j in range(4)] for i in range(4)]
    v = transform_point(w2v, world)
    neg_z = torch.clamp(-v.z, min=1e-6)
    px = ((v.x / neg_z) / scalar(p.sx_prev) + 1.0) * 0.5 * width - 0.5
    py = (1.0 - (v.y / neg_z) / scalar(p.sy_prev)) * 0.5 * height - 0.5
    valid = ((v.z < -1e-3) & (px >= 0.0) & (px <= width - 1.0) & (py >= 0.0)
             & (py <= height - 1.0))

    # ---- the TPU's history window: base and validity rule, in the
    # history band's rows (taa.py:130-136) ----
    def base(coord, own, margin, align, limit):
        lo = _per_tile(torch.where(valid, coord, own), rows, width).amin(dim=(1, 3))
        b = torch.clamp(torch.floor(lo).to(torch.int64) - margin, 0, limit)
        return _per_pixel(b // align * align, rows, width)

    pyl = py - float(p.hist_row0)
    ry0 = base(pyl, iy - float(p.hist_row0), 2, 8, hist_rows - p.win_rows)
    rx0 = base(px, ix, 8, 128, width - p.win_cols)
    rmax = float(np.float32(p.win_rows - 1.001))
    cmax = float(np.float32(p.win_cols - 1.001))
    ryf = pyl - ry0.to(torch.float32)
    rxf = px - rx0.to(torch.float32)
    valid = valid & (ryf >= 0.0) & (ryf <= rmax) & (rxf >= 0.0) & (rxf <= cmax)
    ryf = torch.clamp(ryf, 0.0, rmax)
    rxf = torch.clamp(rxf, 0.0, cmax)
    r0, c0 = torch.floor(ryf), torch.floor(rxf)
    wy, wx = ryf - r0, rxf - c0

    # ---- bilinear history (direct gathers) and depth validity ----
    o00 = (ry0 + r0.to(torch.int64)) * width + rx0 + c0.to(torch.int64)
    corners = (o00, o00 + 1, o00 + width, o00 + width + 1)

    def bilinear(plane, w_x, w_y):
        v00, v01, v10, v11 = (plane[o] for o in corners)
        return _lerp(_lerp(v00, v01, w_x), _lerp(v10, v11, w_x), w_y)

    hist = bilinear(history.reshape(hist_rows * width, 3), wx[..., None], wy[..., None])
    hist_ld = bilinear(torch.clamp(history_depth, max=DEPTH_CLAMP).reshape(-1), wx, wy)
    valid = valid & ((hist_ld - ld).abs() <= p.depth_eps * torch.clamp(ld, min=1e-3))

    # ---- 3x3 tile-local clamp: taps across the tile edge or on pad rows
    # take the centre value; the TPU's roll order (rows y+1, y, y-1 outer,
    # columns x+1, x, x-1 inner) ----
    c = torch.cat([cur, torch.zeros((pad, width, 3), **f32)])
    c4 = c.reshape(rows // TILE_ROWS, TILE_ROWS, width // TILE_COLS, TILE_COLS, 3)
    ok4 = _per_tile(in_frame, rows, width)
    lr = torch.arange(TILE_ROWS, device=dev)[:, None, None, None]
    lc = torch.arange(TILE_COLS, device=dev)[:, None]
    lo, hi, m1, m2 = c4, c4, c4, c4 * c4
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            if sy == 0 and sx == 0:
                continue
            n = torch.roll(c4, (sy, sx), (1, 3))
            ok = torch.roll(ok4, (sy, sx), (1, 3))[..., None]
            if sy:
                ok = ok & (lr != (TILE_ROWS - 1 if sy < 0 else 0))
            if sx:
                ok = ok & (lc != (TILE_COLS - 1 if sx < 0 else 0))
            n = torch.where(ok, n, c4)
            if p.variance:
                m1 = m1 + n
                m2 = m2 + n * n
            else:
                lo = torch.minimum(lo, n)
                hi = torch.maximum(hi, n)
    if p.variance:
        ninth = float(np.float32(1.0 / 9.0))
        mu = m1 * ninth
        sigma = torch.sqrt(torch.clamp(m2 * ninth - mu * mu, min=0.0))
        lo = mu - p.clamp_gamma * sigma
        hi = mu + p.clamp_gamma * sigma
    lo, hi = lo.reshape(rows, width, 3), hi.reshape(rows, width, 3)
    h = torch.minimum(torch.maximum(hist, lo), hi)
    a = torch.where(valid, p.blend, 1.0)[..., None]
    out = c * a + h * (1.0 - a)
    return (out[:p.rows], torch.clamp(linear_depth, max=DEPTH_CLAMP), valid[:p.rows])


_LAUNCHER = None


def _launcher():
    """``taa_launch`` bound, after checking the struct mirror's size."""
    global _LAUNCHER
    if _LAUNCHER is None:
        size = library.function("taa_params_size", ())()
        if size != ctypes.sizeof(TaaParams):
            raise RuntimeError(f"TaaParams mirror is {ctypes.sizeof(TaaParams)} bytes, "
                               f"the kernel's struct {size}")
        _LAUNCHER = library.function("taa_launch", LAUNCHER_ARGTYPES)
    return _LAUNCHER


def info() -> dict:
    """What the kernel uses on this card (:data:`INFO`): CTAs per tile,
    threads per CTA, registers, local memory (stack), resident CTAs per SM,
    dynamic shared memory per CTA and resident clusters on the card."""
    out = (ctypes.c_int * len(INFO))()
    _launcher()
    rc = library.function("taa_info", INFO_ARGTYPES)(out)
    if rc != 0:
        raise RuntimeError(f"taa_info failed: CUDA error {rc}")
    return dict(zip(INFO, out))


def launch(p: TaaParams, cur: torch.Tensor, linear_depth: torch.Tensor,
           history: torch.Tensor, history_depth: torch.Tensor, out: torch.Tensor,
           depth_out: torch.Tensor, valid: torch.Tensor = None):
    """One kernel launch on launch struct ``p`` into preallocated CUDA
    outputs (``out`` (H, W, 3), ``depth_out`` (H, W); ``valid``: an
    optional (H, W) uint8 plane for each pixel's validity), on the current
    stream of their device (:func:`library.launch`); counted in
    ``counters.launches``.  The caller
    guarantees contiguous float32 tensors of the struct's shapes on one
    device, and that ``depth_out`` and ``out`` alias no input.  ``cur`` and
    ``out`` move 16 bytes at a time: a plane that is not 16-byte aligned
    raises."""
    if cur.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("taa launch: the current and output rgb planes must be 16-byte "
                         "aligned")
    with span("port.taa.launch"):
        rc = library.launch(_launcher(), out, (
            ctypes.byref(p), cur.data_ptr(), linear_depth.data_ptr(), history.data_ptr(),
            history_depth.data_ptr(), out.data_ptr(), depth_out.data_ptr(),
            None if valid is None else valid.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"taa launch failed: CUDA error {rc}")
    counters.launches += 1


def flight_constants(camera: Camera, cam_stack: np.ndarray, settings: TaaSettings,
                     height: int, width: int, row0: int = 0, rows=None,
                     halo: int = 0) -> list:
    """Every frame's launch struct of a TAA flight, on the host: frame i
    resolves against frame i − 1's camera (frame 0 against its own, with
    blend 1.0: it has no history).  A row shard's flight: ``rows`` rows
    from ``row0``, against a history of those rows and ``halo`` more above
    and below."""
    with span("port.taa.flight_constants"):
        rows = height if rows is None else rows
        cam = Camera(view_to_world=_host(camera.view_to_world), fov_y_rad=_host(camera.fov_y_rad),
                     near=_host(camera.near), far=_host(camera.far))
        cams = [dataclasses.replace(cam, view_to_world=torch.from_numpy(np.asarray(m, np.float32)))
                for m in cam_stack]
        return [taa_constants(cams[max(i - 1, 0)], cams[i], 1.0 if i == 0 else settings.blend,
                              height, width, rows + 2 * halo, settings.depth_eps,
                              settings.clamp_mode, settings.clamp_gamma, rows=rows, row0=row0,
                              hist_row0=row0 - halo) for i in range(len(cams))]


def _check_planes(cur, linear_depth, history, history_depth, width):
    h, hh = cur.shape[0], history.shape[0]
    want = ((cur, (h, width, 3)), (linear_depth, (h, width)), (history, (hh, width, 3)),
            (history_depth, (hh, width)))
    device = cur.device
    for t, shape in want:
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"taa_resolve: expected {shape} on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _prepare(cur_color, linear_depth, history, cam_prev, cam_cur, blend, height, width,
             history_depth, depth_eps, clamp_mode, clamp_gamma, row0, hist_row0) -> tuple:
    """The JAX wrapper's checks, then ``(launch struct, history depth)``."""
    rows, hist_rows = int(cur_color.shape[0]), int(history.shape[0])
    check_shapes(rows, hist_rows, width, clamp_mode)
    if history_depth is None:
        history_depth = linear_depth
    _check_planes(cur_color, linear_depth, history, history_depth, width)
    p = taa_constants(cam_prev, cam_cur, blend, height, width, hist_rows, depth_eps, clamp_mode,
                      clamp_gamma, rows=rows, row0=row0, hist_row0=hist_row0)
    return p, history_depth


def taa_resolve_plain(cur_color, linear_depth, history, cam_prev: Camera, cam_cur: Camera,
                      blend, height: int, width: int, history_depth=None, depth_eps=0.2,
                      clamp_mode: str = "minmax", clamp_gamma=1.25, row0=0,
                      hist_row0=0) -> tuple:
    """:func:`taa_resolve`'s plain version, on tensors on any device
    (counted in ``counters.plain_calls``)."""
    p, history_depth = _prepare(cur_color, linear_depth, history, cam_prev, cam_cur, blend,
                                height, width, history_depth, depth_eps, clamp_mode,
                                clamp_gamma, row0, hist_row0)
    counters.plain_calls += 1
    out, depth, _ = resolve_plain(p, *(t.float() for t in (cur_color, linear_depth, history,
                                                           history_depth)))
    return out, depth


def taa_resolve(cur_color, linear_depth, history, cam_prev: Camera, cam_cur: Camera,
                blend, height: int, width: int, history_depth=None, depth_eps=0.2,
                clamp_mode: str = "minmax", clamp_gamma=1.25, row0=0, hist_row0=0) -> tuple:
    """Blend ``cur_color`` (H, W, 3) with ``history`` (Hh, W, 3)
    reprojected from ``cam_prev`` to ``cam_cur``.  Returns ``(resolved,
    depth)``: the resolved (H, W, 3) frame and the clamped linear depth to
    carry as the next frame's ``history_depth``.  ``history_depth=None``
    (first frame) compares the depth against itself.

    Band mode (row sharding): ``cur_color``/``linear_depth`` are one
    shard's rows of a ``height``-row frame from global row ``row0``, and
    ``history``/``history_depth`` its history band from global row
    ``hist_row0`` (the shard's first row minus the halo); ``height`` and
    ``width`` stay the whole frame's.  Both offsets are 0 for a whole frame.

    CPU tensors take the plain version (:func:`taa_resolve_plain`); CUDA
    tensors launch the kernel (``counters.launches``).  Raises
    ``ValueError`` for an unknown ``clamp_mode`` or rows % 8 / width % 128
    off the tiling, as the JAX kernel does."""
    device = cur_color.device
    if device.type == "cpu":
        return taa_resolve_plain(cur_color, linear_depth, history, cam_prev, cam_cur, blend,
                                 height, width, history_depth, depth_eps, clamp_mode,
                                 clamp_gamma, row0, hist_row0)
    if device.type != "cuda":
        raise ValueError(f"taa_resolve runs on CUDA devices (got {device})")
    p, history_depth = _prepare(cur_color, linear_depth, history, cam_prev, cam_cur, blend,
                                height, width, history_depth, depth_eps, clamp_mode,
                                clamp_gamma, row0, hist_row0)
    cur_color, linear_depth, history, history_depth = (
        t.to(torch.float32).contiguous()
        for t in (cur_color, linear_depth, history, history_depth))
    out = torch.empty_like(cur_color)
    depth = torch.empty_like(linear_depth)
    launch(p, cur_color, linear_depth, history, history_depth, out, depth)
    return out, depth
