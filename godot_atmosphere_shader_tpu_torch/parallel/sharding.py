"""Row-sharded rendering: the framebuffer's rows split into n shards.

Counterpart of ``godot_atmosphere_shader_tpu/parallel/sharding.py``.  Every
pixel's scattering integral is independent, so a frame splits into n row
shards of ``height / n`` rows with no communication but the final gather;
the one exchange is the sharded TAA flight's, whose reprojection reads
history rows of the neighbouring shards.

The mesh (:class:`RowMesh`, :func:`make_mesh`) is one of two kinds:

* the **local mesh** (``group=None``): one process renders all ``size``
  shards in turn on one device and puts them together; this is how one card
  runs n > 1 shards;
* the **distributed mesh**: a ``torch.distributed`` process group of
  ``size`` ranks, each rendering shard ``get_rank(group)`` on its own
  device (NCCL on cards, gloo on the CPU); the frames are all-gathered and
  the TAA halo rows go to and from the neighbours by point-to-point sends.

Entries, each returning the whole frame on every process:

* :func:`render_frame_megakernel_sharded`, :func:`render_scene_megakernel_sharded`:
  the band entries of the megakernel per shard (``render_band_megakernel``,
  ``render_scene_band_megakernel``: the kernel on CUDA tensors, its plain
  version on CPU tensors);
* :func:`render_frame_sharded`: the plain chain per shard on any device
  (the twin of the JAX XLA ``render_frame_sharded``);
* :func:`render_flight_taa_sharded`: the TAA flight, each shard resolving
  against a history band with ``halo`` rows of each neighbour (K1 and K3
  on CUDA tensors); :func:`render_flight_taa_sharded_plain` is its plain
  version on any device.

:func:`train_step_sharded` is inverse rendering's training step over the
row shards, :func:`sharded_loss_and_gradients` its loss and gradients (the
plain chain per shard, differentiated): the local mesh takes one graph of
every shard, the distributed mesh all-reduces each rank's gradients.

The host functions that size the halo (:func:`reprojection_row_bound`,
:func:`derive_taa_halo`, ``_scene_min_depth``) are host numpy, copied from
the JAX module, and return the same numbers.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.inverse import gradients, leaves
from ..models.params import AtmosphereParams, VariantConfig
from ..ops.kernels import megakernel as mk
from ..ops.kernels import taa
from ..render.opaque import OpaqueScene
from ..render.renderer import render_scene_band
from ..utils.camera import Camera


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D mesh of ``size`` row shards.  ``group=None``: the local mesh,
    one process renders every shard in turn (on ``device``, or on the
    inputs' device when ``None``); a ``torch.distributed`` process group:
    the distributed mesh, this rank renders shard ``get_rank(group)`` on
    ``device``."""

    size: int
    device: Optional[torch.device] = None
    group: object = None

    def shards(self) -> range:
        """The shards this process renders."""
        if self.group is None:
            return range(self.size)
        rank = dist.get_rank(self.group)
        return range(rank, rank + 1)


def make_mesh(size: Optional[int] = None, *, device=None, group=None) -> RowMesh:
    """A local mesh of ``size`` shards (default 1), or with ``group`` (an
    initialised ``torch.distributed`` process group, e.g.
    ``dist.group.WORLD``) the distributed mesh of its ranks, on this rank's
    card for NCCL (``torch.cuda.current_device()``) and the CPU otherwise."""
    if group is not None:
        n = dist.get_world_size(group)
        if size is not None and size != n:
            raise ValueError(f"mesh size {size} but the process group has {n} ranks")
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        return RowMesh(n, torch.device(device), group)
    size = 1 if size is None else int(size)
    if size < 1:
        raise ValueError(f"a mesh has at least one shard, got {size}")
    return RowMesh(size, None if device is None else torch.device(device), None)


def _shard_rows(height: int, mesh: RowMesh) -> int:
    if not isinstance(mesh, RowMesh):
        raise ValueError(f"mesh must be a RowMesh (make_mesh), got {type(mesh).__name__}")
    if height % mesh.size:
        raise ValueError(f"height {height} not divisible by mesh size {mesh.size}")
    return height // mesh.size


def _check_device(mesh: RowMesh, device: torch.device):
    if mesh.device is not None and (mesh.device.type != device.type or (
            mesh.device.index is not None and device.index is not None
            and mesh.device.index != device.index)):
        raise ValueError(f"the mesh renders on {mesh.device}, the inputs are on {device}")


def _check_lod_alignment(configs, h_local: int):
    """Cloud LOD groups rows in fixed vertical blocks; a shard boundary that
    falls inside a group would pair other rows than the whole frame does
    (``sharding.py:62-76``)."""
    for c in configs:
        if not getattr(c, "clouds_enabled", False):
            continue
        align = c.cloud_lod * (c.cloud_coverage_lod if c.cloud_coverage_interp else 1)
        if align > 1 and h_local % align:
            raise ValueError(f"rows per shard ({h_local}) must be a multiple of the cloud LOD "
                             f"group ({align}) — pad the frame height or change the mesh size")


def _gather(mesh: RowMesh, parts, dim: int) -> torch.Tensor:
    """The whole frame from this process's shards, along ``dim``: the local
    mesh concatenates them, the distributed mesh all-gathers its ranks'."""
    if mesh.group is None:
        return torch.cat(parts, dim)
    part = parts[0].contiguous()
    out = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(out, part, group=mesh.group)
    return torch.cat(out, dim)


# -- one frame ------------------------------------------------------------------------


def render_frame_megakernel_sharded(params: AtmosphereParams, config: VariantConfig,
                                    camera: Camera, opaque: Optional[OpaqueScene],
                                    height: int, width: int, mesh: RowMesh,
                                    tex_data=None) -> torch.Tensor:
    """One layer over the opaque pass, row-sharded over ``mesh``: the
    ``(H, W, 3)`` color (``render_frame_pallas_sharded``, ``:107``); each
    shard is ``render_band_megakernel`` of its rows."""
    h = _shard_rows(height, mesh)
    _check_lod_alignment((config,), h)
    _check_device(mesh, camera.view_to_world.device)
    parts = [mk.render_band_megakernel(params, config, camera, opaque, height, width, s * h, h,
                                       tex_data=tex_data)["color"] for s in mesh.shards()]
    return _gather(mesh, parts, 0)


def render_scene_megakernel_sharded(params_seq, configs, camera: Camera,
                                    opaque: Optional[OpaqueScene], height: int, width: int,
                                    mesh: RowMesh, tex_data=None, pano_data=None,
                                    pano_meta=None) -> dict:
    """The far→near layer chain row-sharded over ``mesh`` (the
    everything-on composite: texture pyramids, panorama sky, several
    layers; ``render_scene_pallas_sharded``, ``:166``): ``{"color": (H, W,
    3), "alpha": (H, W)}``.  Each shard is ``render_scene_band_megakernel``
    of its rows; the glow is not applied (``Scene.apply_environment`` on
    the result)."""
    h = _shard_rows(height, mesh)
    _check_lod_alignment(configs, h)
    _check_device(mesh, camera.view_to_world.device)
    outs = [mk.render_scene_band_megakernel(params_seq, configs, camera, opaque, height, width,
                                            s * h, h, tex_data=tex_data, pano_data=pano_data,
                                            pano_meta=pano_meta) for s in mesh.shards()]
    return {"color": _gather(mesh, [o["color"] for o in outs], 0),
            "alpha": _gather(mesh, [o["alpha"] for o in outs], 0)}


def render_frame_sharded(atmospheres, configs, camera: Camera, opaque: Optional[OpaqueScene],
                         height: int, width: int, mesh: RowMesh) -> torch.Tensor:
    """One frame of layers with the rows sharded over ``mesh``, through the
    plain chain on any device (``:485``, the XLA path: textures sampled
    exactly): the ``(H, W, 3)`` color."""
    if isinstance(atmospheres, AtmosphereParams):
        atmospheres = (atmospheres,)
    if isinstance(configs, VariantConfig):
        configs = (configs,)
    h = _shard_rows(height, mesh)
    _check_lod_alignment(configs, h)
    _check_device(mesh, camera.view_to_world.device)
    parts = [render_scene_band(atmospheres, configs, camera, opaque, height, width, s * h,
                               h)["color"] for s in mesh.shards()]
    return _gather(mesh, parts, 0)


# -- training -------------------------------------------------------------------------


def sharded_loss_and_gradients(train, params: AtmosphereParams, config: VariantConfig,
                               camera: Camera, opaque: Optional[OpaqueScene],
                               target: torch.Tensor, height: int, width: int, mesh: RowMesh):
    """``(loss, grads)`` of inverse rendering's loss with the rows sharded
    over ``mesh`` (``__graft_entry__.py::dryrun_multichip``'s
    ``loss_fn``): each shard's loss is the mean of ``(render − target)²``
    over its rows (the plain band chain, ``render_scene_band``, the twin of
    ``_shade_slice``), the loss the mean over shards.  ``train``: knobs of
    ``params``, the one layer, shaded by ``config``; ``target``: the whole
    ``(H, W, 3)`` frame.
    The local mesh differentiates one graph of every shard; on the
    distributed mesh each rank differentiates its own rows and the ranks
    all-reduce the loss and the gradients, so every rank returns the same."""
    h = _shard_rows(height, mesh)
    _check_lod_alignment((config,), h)
    _check_device(mesh, camera.view_to_world.device)
    train = leaves(train)
    p = dataclasses.replace(params, **train)
    losses = []
    for s in mesh.shards():
        color = mk.render_scene_band_plain((p,), (config,), camera, opaque, height, width,
                                           s * h, h)["color"]
        losses.append(torch.mean((color - target[s * h:(s + 1) * h]) ** 2))
    loss = torch.mean(torch.stack(losses))
    grads = gradients(loss, train)
    loss = loss.detach()
    if mesh.group is not None:
        # the one collective training adds: the mean over ranks
        for t in [loss, *grads.values()]:
            dist.all_reduce(t, group=mesh.group)
            t /= mesh.size
    return loss, grads


def train_step_sharded(train, params: AtmosphereParams, config: VariantConfig, camera: Camera,
                       opaque: Optional[OpaqueScene], target: torch.Tensor, height: int,
                       width: int, mesh: RowMesh, lr: float = 1e-3):
    """One SGD step of inverse rendering with the rows sharded over ``mesh``
    (``dryrun_multichip``'s ``train_step``): every knob of ``train`` takes
    ``v − lr·g`` on :func:`sharded_loss_and_gradients`.  Returns ``(loss,
    train)``, detached, the same on every rank."""
    loss, grads = sharded_loss_and_gradients(train, params, config, camera, opaque, target,
                                             height, width, mesh)
    with torch.no_grad():
        new_train = {k: v.detach() - lr * grads[k] for k, v in train.items()}
    return loss, new_train


# -- the TAA halo -------------------------------------------------------------------


class TaaHaloWarning(UserWarning):
    """The flight's camera motion reprojects history from beyond the
    configured halo: those pixels degrade to the current sample near shard
    boundaries."""


def reprojection_row_bound(cam_stack, fov_y_rad: float, height: int, width: int, depths,
                           grid=(16, 24)) -> float:
    """Max vertical reprojection displacement (in pixel rows) across the
    flight's consecutive frame pairs (``:233-277``): the quantity the TAA
    halo must cover.  Host numpy, the resolve's projection on a ``grid`` of
    pixels (borders included) × the given ``depths``; reprojections that
    land outside the previous frame or behind its camera are excluded."""
    cams = np.asarray(cam_stack, np.float64)
    if cams.ndim != 3 or cams.shape[0] < 2:
        return 0.0
    inv_fy = float(np.tan(fov_y_rad * 0.5))
    aspect = width / height
    iy = np.linspace(0.0, height - 1.0, grid[0])
    ix = np.linspace(0.0, width - 1.0, grid[1])
    iyg, ixg = np.meshgrid(iy, ix, indexing="ij")
    ndc_x = 2.0 * (ixg + 0.5) / width - 1.0
    ndc_y = 1.0 - 2.0 * (iyg + 0.5) / height
    dv = np.stack([ndc_x * aspect * inv_fy, ndc_y * inv_fy, -np.ones_like(ndc_x)], -1)
    dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
    bound = 0.0
    for k in range(1, cams.shape[0]):
        r_cur, t_cur = cams[k, :3, :3], cams[k, :3, 3]
        r_prev, t_prev = cams[k - 1, :3, :3], cams[k - 1, :3, 3]
        dirs = dv @ r_cur.T
        for d in depths:
            pos = t_cur + dirs * float(d)
            v = (pos - t_prev) @ r_prev  # rigid inverse: Rᵀ·(p − t)
            neg_z = -v[..., 2]
            valid = neg_z > 1e-3
            nz = np.where(valid, neg_z, 1.0)
            py = (1.0 - (v[..., 1] / nz) / inv_fy) * 0.5 * height - 0.5
            px = ((v[..., 0] / nz) / (aspect * inv_fy) + 1.0) * 0.5 * width - 0.5
            valid &= (px >= 0.0) & (px <= width - 1.0)
            valid &= (py >= 0.0) & (py <= height - 1.0)
            if valid.any():
                bound = max(bound, float(np.abs(py - iyg)[valid].max()))
    return bound


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _scene_min_depth(opaque: Optional[OpaqueScene], cam_stack, near: float) -> float:
    """Closest opaque surface distance over the flight (host, ``:280-302``):
    spheres by distance to their surface, boxes by center minus
    circumradius."""
    if opaque is None:
        return max(near, 1e-3)
    cams = np.asarray(cam_stack, np.float64)[:, :3, 3]
    d = np.inf
    sc = _host(opaque.sphere_centers)
    if sc.size:
        sr = _host(opaque.sphere_radii)
        dist_ = np.linalg.norm(cams[:, None] - sc[None], axis=-1) - sr[None]
        d = min(d, float(dist_.min()))
    w2b = _host(opaque.box_world_to_box)
    if w2b.size:
        hs = _host(opaque.box_half_sizes)
        for i in range(w2b.shape[0]):
            r = w2b[i, :3, :3]
            c = -r.T @ w2b[i, :3, 3]  # box center in world
            circ = float(np.linalg.norm(hs[i]))
            d = min(d, float(np.linalg.norm(cams - c, axis=-1).min()) - circ)
    return max(float(near), d if np.isfinite(d) else float(near), 1e-3)


def derive_taa_halo(cam_stack, camera: Camera, height: int, width: int, h_local: int,
                    opaque: Optional[OpaqueScene] = None, depth_min=None,
                    margin_rows: int = 8) -> Tuple[int, float]:
    """Size the sharded TAA halo from the flight's camera motion
    (``:305-326``): ``(halo_rows, bound)``, the sampled reprojection row
    bound plus ``margin_rows`` rounded up to a multiple of 8 and clamped to
    [8, ``h_local``], and the raw bound.  ``depth_min`` defaults to the
    closest opaque surface over the flight; the sampled depths include the
    sky's 1e7, where reprojection is rotation only."""
    near = float(_host(camera.near))
    if depth_min is None:
        depth_min = _scene_min_depth(opaque, cam_stack, near)
    depth_min = max(float(depth_min), 1e-3)
    depths = [depth_min, depth_min * 8.0, depth_min * 64.0, 1.0e7]
    bound = reprojection_row_bound(cam_stack, float(_host(camera.fov_y_rad)), height, width,
                                   depths)
    need = int(np.ceil(bound)) + margin_rows
    halo = min(h_local, max(8, -(-need // 8) * 8))
    return halo, bound


def _choose_halo(halo, cam_stack, camera, height, width, h_local, opaque) -> int:
    """The JAX rules (``:405-424``): ``"auto"`` takes the derived halo and
    warns when rows per shard cap it; an int is checked against the derived
    bound and warns when the motion exceeds it; either must be a positive
    multiple of 8 no larger than the rows per shard."""
    derived, bound = derive_taa_halo(cam_stack, camera, height, width, h_local, opaque=opaque)
    if halo == "auto":
        halo = derived
        if bound + 1.0 > h_local:  # +1: the derived margin got clamped away
            warnings.warn(
                f"flight reprojects up to {bound:.0f} rows/frame but rows-per-shard caps the "
                f"halo at {h_local}; history beyond it degrades to the current sample near "
                "shard boundaries (use fewer shards or a taller frame)",
                TaaHaloWarning, stacklevel=3)
    elif int(np.ceil(bound)) > halo:
        warnings.warn(
            f"flight reprojects up to {bound:.0f} rows/frame, beyond the configured halo of "
            f"{halo} (derived need: {derived}); those pixels degrade to the current sample "
            "near shard boundaries", TaaHaloWarning, stacklevel=3)
    if isinstance(halo, bool) or not isinstance(halo, (int, np.integer)) or halo % 8 or not (
            0 < halo <= h_local):
        raise ValueError(f"halo ({halo}) must be a positive multiple of 8 and <= rows per "
                         f"shard ({h_local})")
    return int(halo)


def _exchange(mesh: RowMesh, history: dict, halo: int) -> dict:
    """Each shard's history band: its resolved rows (color (h, W, 3), depth
    (h, W)) with ``halo`` rows of the shard above on top and of the shard
    below underneath, zeros past the frame's edges (``:446-454``).  The
    local mesh slices the neighbours' bands; the distributed mesh sends its
    edge rows and receives its neighbours' in one batch of point-to-point
    operations per direction."""
    def edge(t):
        return torch.zeros((halo,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)

    out = {}
    if mesh.group is None:
        last = mesh.size - 1
        for s, planes in history.items():
            out[s] = tuple(torch.cat([history[s - 1][k][-halo:] if s > 0 else edge(t), t,
                                      history[s + 1][k][:halo] if s < last else edge(t)])
                           for k, t in enumerate(planes))
        return out
    (s, planes), = history.items()
    group = mesh.group
    above = [edge(t) for t in planes]
    below = [edge(t) for t in planes]
    for send_rows, send_to, recv, recv_from in (
            (slice(-halo, None), s + 1, above, s - 1),  # downward: last rows to the shard below
            (slice(0, halo), s - 1, below, s + 1)):  # upward: first rows to the shard above
        ops = []
        if 0 <= send_to < mesh.size:
            peer = dist.get_global_rank(group, send_to)
            ops += [dist.P2POp(dist.isend, t[send_rows].contiguous(), peer, group)
                    for t in planes]
        if 0 <= recv_from < mesh.size:
            peer = dist.get_global_rank(group, recv_from)
            ops += [dist.P2POp(dist.irecv, t, peer, group) for t in recv]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    out[s] = tuple(torch.cat([a, t, b]) for a, t, b in zip(above, planes, below))
    return out


# -- the sharded TAA flight ------------------------------------------------------------


def render_flight_taa_sharded(params_seq, fs_stacks, configs, camera: Camera,
                              opaque: Optional[OpaqueScene], height: int, width: int,
                              mesh: RowMesh, cam_stack=None, blend: float = 0.15, halo="auto",
                              tex_data=None, pano_data=None, pano_meta=None,
                              depth_eps: float = 0.2, clamp_mode: str = "minmax",
                              clamp_gamma: float = 1.25) -> dict:
    """The temporally accumulated flight, row-sharded over ``mesh``
    (``render_flight_taa_sharded``, ``:329-482``): ``{"color": (K, H, W,
    3), "alpha": (K, H, W)}``.

    Each shard renders its rows of every frame (the band chain, temporal
    jitter forced on), then resolves them against a history band of its
    previous resolved rows with ``halo`` rows of each neighbour's above
    and below (zeros past the frame's edges, which the resolve's frame
    bounds reject), with the resolve's band mode.  Frame 0 resolves with
    blend 1.0 against zero history at depth 1e7.  ``halo``: ``"auto"``
    derives it from the camera motion (:func:`derive_taa_halo`), an int is
    checked against the same bound (``TaaHaloWarning``).  Rows per shard
    must be a multiple of 32 (the resolve's tile), ``halo`` a multiple of 8
    no larger than them.  Other arguments as in
    ``megakernel.render_flight_taa``.  CPU tensors take the plain version
    (:func:`render_flight_taa_sharded_plain`); CUDA tensors compute every
    launch struct on the host first, then launch K1 once per layer and
    shard and K3 once per shard, frame after frame."""
    return _sharded_flight(params_seq, fs_stacks, configs, camera, opaque, height, width, mesh,
                           cam_stack, blend, halo, tex_data, pano_data, pano_meta, depth_eps,
                           clamp_mode, clamp_gamma, plain=False)


def render_flight_taa_sharded_plain(params_seq, fs_stacks, configs, camera: Camera,
                                    opaque: Optional[OpaqueScene], height: int, width: int,
                                    mesh: RowMesh, cam_stack=None, blend: float = 0.15,
                                    halo="auto", tex_data=None, pano_data=None, pano_meta=None,
                                    depth_eps: float = 0.2, clamp_mode: str = "minmax",
                                    clamp_gamma: float = 1.25) -> dict:
    """:func:`render_flight_taa_sharded`'s plain version on any device: the
    plain band chain and the plain resolve per shard and frame (counted in
    the plain counters of ``megakernel.py`` and ``taa.py``), the same
    exchange and gather."""
    return _sharded_flight(params_seq, fs_stacks, configs, camera, opaque, height, width, mesh,
                           cam_stack, blend, halo, tex_data, pano_data, pano_meta, depth_eps,
                           clamp_mode, clamp_gamma, plain=True)


def _sharded_flight(params_seq, fs_stacks, configs, camera, opaque, height, width, mesh,
                    cam_stack, blend, halo, tex_data, pano_data, pano_meta, depth_eps,
                    clamp_mode, clamp_gamma, plain: bool) -> dict:
    configs = tuple(dataclasses.replace(c, temporal_jitter=True) for c in configs)
    h = _shard_rows(height, mesh)
    if h % 32:
        raise ValueError(f"rows per shard ({h}) must be a multiple of 32 (TAA resolve tile "
                         "height) for single-chip alignment")
    fs_stacks = [np.ascontiguousarray(fs, np.float32) for fs in fs_stacks]
    k = fs_stacks[0].shape[0]
    if cam_stack is None:
        cam_stack = np.broadcast_to(_host(camera.view_to_world), (k, 4, 4))
    cam_stack = np.ascontiguousarray(cam_stack, np.float32)
    if (len(fs_stacks) != len(configs) or k < 1 or cam_stack.shape != (k, 4, 4)
            or any(fs.shape != (k, 24) for fs in fs_stacks)):
        raise ValueError(f"a flight needs per layer (K, 24) frame states and (K, 4, 4) "
                         f"transforms, got {[fs.shape for fs in fs_stacks]} and "
                         f"{cam_stack.shape}")
    halo = _choose_halo(halo, cam_stack, camera, height, width, h, opaque)
    _check_lod_alignment(configs, h)
    device, tex, _, _ = mk._check_layers(params_seq, configs, camera, opaque, height, tex_data,
                                         None, None, pano_data, pano_meta, shard=(0, h))
    _check_device(mesh, device)
    taa.check_shapes(h, h + 2 * halo, width, clamp_mode)
    settings = taa.TaaSettings(float(blend), float(depth_eps), clamp_mode, float(clamp_gamma))
    shards = list(mesh.shards())
    resolves = {s: taa.flight_constants(camera, cam_stack, settings, height, width, s * h, h,
                                        halo) for s in shards}
    f32 = dict(dtype=torch.float32, device=device)
    color = {s: torch.empty((k, h, width, 3), **f32) for s in shards}
    alpha = {s: torch.empty((k, h, width), **f32) for s in shards}
    history = {s: (torch.zeros((h, width, 3), **f32), torch.full((h, width), taa.DEPTH_CLAMP,
                                                                 **f32)) for s in shards}
    if not plain and device.type == "cuda":
        # every launch struct on the host first: no device->host copy from
        # the first launch to the last
        launches = mk.band_flight_launches(params_seq, fs_stacks, configs, camera, opaque,
                                           height, width, cam_stack, [(s * h, h) for s in shards],
                                           tex_data=tex, pano_data=pano_data,
                                           pano_meta=pano_meta)
        raw = {s: (torch.empty((h, width, 3), **f32), torch.empty((h, width), **f32))
               for s in shards}

        def render(i, j, s):
            for struct, args in launches[i][j]:
                mk.launch(struct, raw[s][0], alpha[s][i], depth=raw[s][1], **args)
            return raw[s]

        def resolve(i, s, cur, ext):
            depth = torch.empty((h, width), **f32)
            taa.launch(resolves[s][i], *cur, *ext, color[s][i], depth)
            return color[s][i], depth
    else:
        mk.counters.plain_calls += k * len(shards)
        taa.counters.plain_calls += k * len(shards)

        def render(i, j, s):
            ps = [dataclasses.replace(p, frame_state=torch.as_tensor(fs[i], device=device))
                  for p, fs in zip(params_seq, fs_stacks)]
            cam_i = dataclasses.replace(camera, view_to_world=torch.as_tensor(cam_stack[i],
                                                                              device=device))
            out = render_scene_band(ps, configs, cam_i, opaque, height, width, s * h, h,
                                    tex_data=tex, pano_data=pano_data, pano_meta=pano_meta)
            alpha[s][i] = out["alpha"]
            return out["color"], out["linear_depth"]

        def resolve(i, s, cur, ext):
            out, depth, _ = taa.resolve_plain(resolves[s][i], *cur, *ext)
            color[s][i] = out
            return color[s][i], depth

    for i in range(k):
        cur = {s: render(i, j, s) for j, s in enumerate(shards)}
        ext = _exchange(mesh, history, halo)
        history = {s: resolve(i, s, cur[s], ext[s]) for s in shards}
    return {"color": _gather(mesh, [color[s] for s in shards], 1),
            "alpha": _gather(mesh, [alpha[s] for s in shards], 1)}
