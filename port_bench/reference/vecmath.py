"""Structure-of-arrays 3D vector math on torch tensors.

Counterpart of ``godot_atmosphere_shader_tpu/utils/vecmath.py``: each
``Vec3`` component is a full ``(H, W)`` plane (or a 0-d tensor / Python float
for per-frame constants), so every operation below is a plain elementwise
tensor op.  The plain PyTorch render path is built from these; the CUDA
megakernel (``ops/kernels/megakernel.py``) computes the same formulas per
thread in the same operation order.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class Vec3(NamedTuple):
    """SoA 3-vector: x, y, z are tensors of identical shape (or scalars)."""

    x: Scalar
    y: Scalar
    z: Scalar

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def cmul(self, o: "Vec3") -> "Vec3":
        """Component-wise product (GLSL ``a * b`` on vec3)."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3) -> Vec3:
    inv = torch.rsqrt(dot(a, a))
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def lerp(a, b, t):
    """GLSL ``mix``."""
    return a + (b - a) * t


def maximum(a, b):
    """``jnp.maximum`` for any mix of tensors and Python floats."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, min=b)
    return torch.maximum(a, b)


def minimum(a, b):
    """``jnp.minimum`` for any mix of tensors and Python floats."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b)


def clamp(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def saturate(x):
    return clamp(x, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = saturate((x - edge0) / (edge1 - edge0))
    return t * t * (3.0 - 2.0 * t)


def pow2(x):
    return x * x


def pow4(x):
    x2 = x * x
    return x2 * x2


# -- ray intersectors -------------------------------------------------------

#: Sentinel returned by :func:`ray_sphere` on a miss (the reference's
#: ``vec2(1e6, 1e6)``, hit tested with ``t0 != t1``).
RAY_SPHERE_MISS = 1.0e6


def ray_sphere(center: Vec3, radius, ray_origin: Vec3, ray_dir: Vec3):
    """Ray/sphere intersection with the reference's miss convention.

    Returns ``(t_near, t_far)``; both equal ``RAY_SPHERE_MISS`` where the
    ray misses.  ``ray_dir`` must be normalized and hold the pixel planes.
    """
    oc = ray_origin - center
    b = dot(oc, ray_dir)
    qc = oc - ray_dir * b
    h = radius * radius - dot(qc, qc)
    miss = h < 0.0
    sq = torch.sqrt(torch.where(miss, 1.0, torch.clamp(h, min=1e-12)))
    t0 = torch.where(miss, RAY_SPHERE_MISS, -b - sq)
    t1 = torch.where(miss, RAY_SPHERE_MISS, -b + sq)
    return t0, t1


def ray_box(ray_origin: Vec3, ray_dir: Vec3, box_half_size: Vec3):
    """Axis-aligned box intersection, box centered at the origin.

    Returns ``(t_near, t_far, hit_mask)`` with ``(-1, -1)`` on a miss.
    """

    def safe_inv(d):
        # guard axis-aligned rays: 1/0 → ±inf then 0·inf → NaN
        tiny = 1e-12
        d = torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
        return 1.0 / d

    inv = Vec3(safe_inv(ray_dir.x), safe_inv(ray_dir.y), safe_inv(ray_dir.z))
    n = inv.cmul(ray_origin)
    k = Vec3(inv.x.abs(), inv.y.abs(), inv.z.abs()).cmul(box_half_size)
    t1 = -n - k
    t2 = -n + k
    t_near = torch.maximum(torch.maximum(t1.x, t1.y), t1.z)
    t_far = torch.minimum(torch.minimum(t2.x, t2.y), t2.z)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    t_near = torch.where(hit, t_near, -1.0)
    t_far = torch.where(hit, t_far, -1.0)
    return t_near, t_far, hit


# -- color blending ---------------------------------------------------------


def blend_colors(self_rgb: Vec3, self_a, over_rgb: Vec3, over_a):
    """Alpha blend of ``util.gdshaderinc:61-69``; transparent black where the
    combined alpha is zero.  Returns ``(rgb, a)``."""
    sa = 1.0 - over_a
    a = self_a * sa + over_a
    zero = a == 0.0
    safe = torch.where(zero, 1.0, a)
    rgb = (self_rgb * (self_a * sa) + over_rgb * over_a) * (1.0 / safe)
    rgb = Vec3(torch.where(zero, 0.0, rgb.x),
               torch.where(zero, 0.0, rgb.y),
               torch.where(zero, 0.0, rgb.z))
    return rgb, a
