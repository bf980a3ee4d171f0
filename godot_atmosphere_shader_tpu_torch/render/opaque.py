"""Analytic opaque pass: the stand-in for Godot's rasterized scene.

Counterpart of ``godot_atmosphere_shader_tpu/render/opaque.py``: spheres,
boxes, a directional light with ambient, a sky (a color with a hashed
starfield, or an equirect panorama: the reference demo's
``PanoramaSkyMaterial``) and the depth buffers the atmosphere composites
against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.noise import _hash_to_unit, hash3
from ..ops.sampling import sample_equirect_bilinear
from ..utils import host_mirror
from ..utils.camera import (Camera, background_depth,
                            nonlinear_depth_from_view_z, transform_dir,
                            transform_point, world_ray_dirs)
from ..utils.profiling import span
from ..utils.vecmath import Vec3, normalize, ray_box, ray_sphere

#: star cells per unit of ray direction, hash seed, and brightness knee of
#: the procedural starfield
STAR_CELLS = 220.0
STAR_SEED = 77
STAR_KNEE = 0.7


@dataclasses.dataclass
class OpaqueScene:
    """Spheres + boxes + directional light, as stacked tensors."""

    sphere_centers: torch.Tensor  # (S, 3)
    sphere_radii: torch.Tensor  # (S,)
    sphere_albedos: torch.Tensor  # (S, 3) linear
    sphere_unshaded: torch.Tensor  # (S,) 1.0 ⇒ emissive/unshaded
    box_world_to_box: torch.Tensor  # (B, 4, 4)
    box_half_sizes: torch.Tensor  # (B, 3)
    box_albedos: torch.Tensor  # (B, 3)
    light_dir: torch.Tensor  # (3,) direction light travels
    ambient: torch.Tensor  # 0-d
    sky_color: torch.Tensor  # (3,) linear
    star_intensity: torch.Tensor  # 0-d; 0 disables the starfield
    # equirect sky (H, W, 3) linear RGB, or None: when set it replaces
    # sky_color + starfield on rays that miss all geometry (sampled exactly
    # by ops/sampling.py::sample_equirect_bilinear, or through the mip
    # pyramids the megakernel samples, ops/kernels/texsample.py)
    panorama: Optional[torch.Tensor] = None

    @staticmethod
    def create(spheres=(), boxes=(), light_dir=(0.0, 0.0, -1.0),
               ambient=0.02, sky_color=(0.0, 0.0, 0.0), star_intensity=0.0,
               panorama=None, *, device="cuda") -> "OpaqueScene":
        """``spheres``: list of (center, radius, albedo[, unshaded]);
        ``boxes``: list of (world_to_box 4×4, half_size, albedo);
        ``panorama``: an optional (H, W, 3) linear equirect sky."""
        if spheres:
            sc = np.array([s[0] for s in spheres], np.float32)
            sr = np.array([s[1] for s in spheres], np.float32)
            sa = np.array([s[2] for s in spheres], np.float32)
            su = np.array([float(s[3]) if len(s) > 3 else 0.0 for s in spheres],
                          np.float32)
        else:
            sc, sr, sa, su = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                              np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
        if boxes:
            bm = np.array([b[0] for b in boxes], np.float32)
            bh = np.array([b[1] for b in boxes], np.float32)
            ba = np.array([b[2] for b in boxes], np.float32)
        else:
            bm, bh, ba = (np.zeros((0, 4, 4), np.float32),
                          np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))

        def t(v):  # with its host mirror: the launch structs read it with no copy
            return host_mirror.upload(np.asarray(v, np.float32), device,
                                      site="port.copy.opaque_create")

        return OpaqueScene(
            sphere_centers=t(sc), sphere_radii=t(sr), sphere_albedos=t(sa),
            sphere_unshaded=t(su), box_world_to_box=t(bm), box_half_sizes=t(bh),
            box_albedos=t(ba), light_dir=t(light_dir), ambient=t(ambient),
            sky_color=t(sky_color), star_intensity=t(star_intensity),
            panorama=None if panorama is None else torch.as_tensor(
                np.asarray(panorama, np.float32), device=device))


    def rebased(self, origin, host_cache: Optional[dict] = None) -> "OpaqueScene":
        """Camera-relative copy: world positions shifted by ``-origin``,
        subtracted on the host in float64 and cast to float32, so geometry
        near the camera keeps full float32 precision however far from the
        world origin it sits (the large-world path).  ``host_cache``
        (caller-owned) keeps the float64 host copies across frames."""
        if host_cache is not None and "sc" in host_cache:
            sc, bm = host_cache["sc"], host_cache["bm"]
        else:
            with span("port.copy.opaque_rebase", self.sphere_centers.device):
                sc = self.sphere_centers.detach().cpu().numpy().astype(np.float64)
            with span("port.copy.opaque_rebase", self.box_world_to_box.device):
                bm = self.box_world_to_box.detach().cpu().numpy().astype(np.float64)
            if host_cache is not None:
                host_cache["sc"], host_cache["bm"] = sc, bm
        o = np.asarray(origin, np.float64)
        sc_rel = (sc - o).astype(np.float32)
        bm_rel = bm.copy()
        if bm_rel.shape[0]:
            # box = M·p_world, p_world = p_rel + origin  ⇒  t' = t + R·origin
            bm_rel[:, :3, 3] += bm_rel[:, :3, :3] @ o
        device = self.sphere_centers.device
        with span("port.copy.opaque_rebase", device):
            centers = torch.as_tensor(sc_rel, device=device)
        with span("port.copy.opaque_rebase", device):
            boxes = torch.as_tensor(bm_rel.astype(np.float32), device=device)
        return dataclasses.replace(self, sphere_centers=centers, box_world_to_box=boxes)


def starfield(ray_dir: Vec3, star_intensity):
    """Sparse hashed glints from the quantized ray direction."""
    cx = torch.floor(ray_dir.x * STAR_CELLS).to(torch.int32)
    cy = torch.floor(ray_dir.y * STAR_CELLS).to(torch.int32)
    cz = torch.floor(ray_dir.z * STAR_CELLS).to(torch.int32)
    b = _hash_to_unit(hash3(cx, cy, cz, STAR_SEED))
    b2 = b * b
    b4 = b2 * b2
    b16 = b4 * b4
    b16 = b16 * b16
    return torch.clamp(b16 - STAR_KNEE, min=0.0) * (1.0 / 0.3) * star_intensity


def render_opaque(scene: OpaqueScene, camera: Camera, height: int, width: int,
                  reverse_z: bool = True, ray_dir: Optional[Vec3] = None,
                  sky_fn=None):
    """Returns ``(rgb: Vec3, depth: nonlinear buffer, linear_depth)``.

    ``sky_fn(ray_dir: Vec3) -> Vec3``: the sky of rays that miss all
    geometry, in place of ``sky_color`` + starfield; it is called on every
    ray as given (not renormalized).  Without one, a scene with a panorama
    samples it exactly (:func:`sample_equirect_bilinear`)."""
    if ray_dir is None:
        ray_dir = world_ray_dirs(camera, height, width)
    ray_origin = camera.position
    like = ray_dir.x

    big = 3.0e38
    best_t = torch.full_like(like, big)
    nx, ny, nz = (torch.zeros_like(like) for _ in range(3))
    ar, ag, ab = (torch.zeros_like(like) for _ in range(3))
    unshaded = torch.zeros_like(like)

    for i in range(scene.sphere_centers.shape[0]):
        c = scene.sphere_centers[i]
        center = Vec3(c[0], c[1], c[2])
        t0, t1 = ray_sphere(center, scene.sphere_radii[i], ray_origin, ray_dir)
        hit = (t0 != t1) & (t1 > 0.0)
        t = torch.where(t0 > 0.0, t0, t1)  # front hit, or inside → back wall
        closer = hit & (t < best_t)
        n = normalize(ray_origin + ray_dir * t - center)
        best_t = torch.where(closer, t, best_t)
        nx = torch.where(closer, n.x, nx)
        ny = torch.where(closer, n.y, ny)
        nz = torch.where(closer, n.z, nz)
        ar = torch.where(closer, scene.sphere_albedos[i, 0], ar)
        ag = torch.where(closer, scene.sphere_albedos[i, 1], ag)
        ab = torch.where(closer, scene.sphere_albedos[i, 2], ab)
        unshaded = torch.where(closer, scene.sphere_unshaded[i], unshaded)

    for i in range(scene.box_world_to_box.shape[0]):
        m = scene.box_world_to_box[i]
        ro_b = transform_point(m, ray_origin)
        rd_b = transform_dir(m, ray_dir)
        hs = scene.box_half_sizes[i]
        ones = torch.ones_like(best_t)
        t0, t1, hit = ray_box(ro_b, rd_b, Vec3(hs[0] * ones, hs[1] * ones,
                                               hs[2] * ones))
        t = torch.where(t0 > 0.0, t0, t1)
        hit = hit & (t > 0.0)
        closer = hit & (t < best_t)
        # box normal: dominant axis of the local hit point
        pb = ro_b + rd_b * t
        axx = (pb.x / hs[0]).abs()
        ayy = (pb.y / hs[1]).abs()
        azz = (pb.z / hs[2]).abs()
        n_local = Vec3(
            torch.where((axx >= ayy) & (axx >= azz), torch.sign(pb.x), 0.0),
            torch.where((ayy > axx) & (ayy >= azz), torch.sign(pb.y), 0.0),
            torch.where((azz > axx) & (azz > ayy), torch.sign(pb.z), 0.0))
        # local → world: transpose of the rigid world_to_box rotation
        n = Vec3(m[0, 0] * n_local.x + m[1, 0] * n_local.y + m[2, 0] * n_local.z,
                 m[0, 1] * n_local.x + m[1, 1] * n_local.y + m[2, 1] * n_local.z,
                 m[0, 2] * n_local.x + m[1, 2] * n_local.y + m[2, 2] * n_local.z)
        best_t = torch.where(closer, t, best_t)
        nx = torch.where(closer, n.x, nx)
        ny = torch.where(closer, n.y, ny)
        nz = torch.where(closer, n.z, nz)
        ar = torch.where(closer, scene.box_albedos[i, 0], ar)
        ag = torch.where(closer, scene.box_albedos[i, 1], ag)
        ab = torch.where(closer, scene.box_albedos[i, 2], ab)
        unshaded = torch.where(closer, 0.0, unshaded)

    hit_any = best_t < big
    if sky_fn is None and scene.panorama is not None:
        def sky_fn(d, _tex=scene.panorama):
            return sample_equirect_bilinear(_tex, d)
    if sky_fn is not None:
        sky = sky_fn(ray_dir)
    else:
        star = starfield(ray_dir, scene.star_intensity)
        sky = Vec3(*(c + star for c in scene.sky_color))

    # lambert + ambient, unshaded passthrough
    ld = scene.light_dir
    ndotl = torch.clamp(-(nx * ld[0] + ny * ld[1] + nz * ld[2]), min=0.0)
    shade = scene.ambient + (1.0 - scene.ambient) * ndotl
    shade = torch.where(unshaded > 0.5, 1.0, shade)
    rgb = Vec3(torch.where(hit_any, ar * shade, sky.x),
               torch.where(hit_any, ag * shade, sky.y),
               torch.where(hit_any, ab * shade, sky.z))

    # depth buffer: view-space z of hits, clear value elsewhere
    hit_pos = ray_origin + ray_dir * torch.where(hit_any, best_t, 1.0)
    pv = transform_point(camera.world_to_view, hit_pos)
    depth = nonlinear_depth_from_view_z(camera, pv.z, reverse_z=reverse_z)
    depth = torch.where(hit_any, depth, background_depth(reverse_z))
    linear_depth = torch.where(hit_any, best_t, 1e7)
    return rgb, depth, linear_depth
