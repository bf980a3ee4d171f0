"""The plain TAA resolve (K3's plain version) and a flight's per-frame
resolve structs, frozen from the port's ``ops/kernels/taa.py``: only the
plain parts, with no kernel library.

A resolve reprojects each pixel from the current linear depth into the
previous camera, reads the history bilinearly from a window of the
previous resolved frame, clamps it to the 3x3 neighbourhood of the current
frame (per 32x128 tile) and blends.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .camera import Camera, ray_scale, rigid_inverse, transform_dir, transform_point
from .vecmath import Vec3

#: the TPU kernel's history window (rows aligned to 8, columns to 128)
WIN_ROWS = 64
WIN_COLS = 384
TILE_ROWS, TILE_COLS = 32, 128
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


def flight_constants(camera: Camera, cam_stack: np.ndarray, settings: TaaSettings,
                     height: int, width: int, row0: int = 0, rows=None,
                     halo: int = 0) -> list:
    """Every frame's launch struct of a TAA flight, on the host: frame i
    resolves against frame i − 1's camera (frame 0 against its own, with
    blend 1.0: it has no history).  A row shard's flight: ``rows`` rows
    from ``row0``, against a history of those rows and ``halo`` more above
    and below."""
    rows = height if rows is None else rows
    cam = Camera(view_to_world=_host(camera.view_to_world), fov_y_rad=_host(camera.fov_y_rad),
                 near=_host(camera.near), far=_host(camera.far))
    cams = [dataclasses.replace(cam, view_to_world=torch.from_numpy(np.asarray(m, np.float32)))
            for m in cam_stack]
    return [taa_constants(cams[max(i - 1, 0)], cams[i], 1.0 if i == 0 else settings.blend,
                          height, width, rows + 2 * halo, settings.depth_eps,
                          settings.clamp_mode, settings.clamp_gamma, rows=rows, row0=row0,
                          hist_row0=row0 - halo) for i in range(len(cams))]
