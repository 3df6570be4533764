"""Camera model and per-pixel ray generation.

Replacement for the reference's rasterized proxy-geometry trick:
the reference renders the front faces of a unit cube and lets the rasterizer
interpolate ``vUV = vVertex + 0.5`` per fragment (``raycaster.vert:20``,
``UnitBrick.h:54-99``), so each fragment's ray starts at the cube entry point in
texture space.  Here the same entry points are computed analytically: a pinhole
camera (GLM ``lookAt`` + ``perspectiveFov`` conventions, ``main.cpp:396-397``)
generates a world ray per pixel, and a slab-test ray/box intersection against the
unit cube [-0.5, 0.5]^3 yields the entry point.  Pixels whose rays miss the cube
are masked (the GL pipeline simply produces no fragment for them).

Defaults mirror ``main.cpp``: camera at (0, 0, -0.75) looking along +z with up
(0, 1, 0) (``main.cpp:33-35``), vertical fov 50 deg (``main.cpp:40``), and a
1600x1200 viewport (``main.cpp:27``).  Image rows are generated top-to-bottom
(row 0 = top), i.e. flipped relative to GL's bottom-left origin.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Camera", "look_at_basis", "generate_rays", "RayBundle",
           "orbit_camera"]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera in the volume's object space (unit cube at the origin)."""

    position: tuple[float, float, float] = (0.0, 0.0, -0.75)
    front: tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_degrees: float = 50.0
    width: int = 1600
    height: int = 1200

    @property
    def aspect(self) -> float:
        return self.width / self.height


def orbit_camera(az_deg: float, width: int, height: int) -> Camera:
    """The reference's default eye (0, 0, -0.75) orbited ``az_deg`` degrees
    around +y, always looking at the volume center (``main.cpp:33-35``)."""
    a = np.radians(az_deg)
    return Camera(width=width, height=height,
                  position=(0.75 * float(np.sin(a)), 0.0,
                            -0.75 * float(np.cos(a))),
                  front=(-float(np.sin(a)), 0.0, float(np.cos(a))))


def look_at_basis(position, front, up):
    """Orthonormal camera basis following GLM ``lookAt`` (``main.cpp:396``):
    f = normalize(front), s = normalize(cross(f, up)), u = cross(s, f)."""
    f = front / jnp.linalg.norm(front)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    return s, u, f


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """Per-pixel rays in object space.

    Attributes:
      entry_uv: (H, W, 3) cube entry point in texture space [0,1]^3 (vUV).
      direction: (H, W, 3) normalized march direction (``raycaster.frag:27``).
      hit: (H, W) bool, True where the ray intersects the unit cube.
    """

    entry_uv: jnp.ndarray
    direction: jnp.ndarray
    hit: jnp.ndarray


@partial(jax.jit, static_argnums=(1, 2))
def _generate_rays(params, width: int, height: int):
    position, front, up, tan_half_fov = params
    s, u, f = look_at_basis(position, front, up)

    # Pixel centers -> NDC.  Row 0 = top of the image (flip vs GL's bottom origin).
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    ndc_x, ndc_y = jnp.meshgrid(px, py)  # (H, W)

    # View-space direction; glm::perspectiveFov(fov, W, H): m00 = cot(fov/2)*H/W,
    # m11 = cot(fov/2), so x scales by tan(fov/2)*W/H and y by tan(fov/2).
    aspect = width / height
    dx = ndc_x * tan_half_fov * aspect
    dy = ndc_y * tan_half_fov
    # World direction: columns of the inverse view rotation are (s, u, -f); with
    # view dir (dx, dy, -1) this is  s*dx + u*dy + f.
    d = dx[..., None] * s + dy[..., None] * u + f
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    # Slab test against the unit cube [-0.5, 0.5]^3.
    eye = jnp.broadcast_to(position, d.shape)
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.sign(d) * 1e12 + (d == 0) * 1e12)
    t0 = (-0.5 - eye) * inv_d
    t1 = (0.5 - eye) * inv_d
    t_near = jnp.minimum(t0, t1).max(axis=-1)
    t_far = jnp.maximum(t0, t1).min(axis=-1)
    hit = (t_far > jnp.maximum(t_near, 0.0))
    t_entry = jnp.maximum(t_near, 0.0)

    entry = eye + t_entry[..., None] * d
    entry_uv = entry + 0.5  # vUV = object position + 0.5 (raycaster.vert:20)

    # Shader-faithful direction: normalize((vUV - 0.5) - camPos) (raycaster.frag:27).
    # With the eye inside the cube the entry point is the eye itself and that
    # vector is zero; those rays march along the pixel direction.
    geom_dir = entry_uv - 0.5 - position
    norm = jnp.linalg.norm(geom_dir, axis=-1, keepdims=True)
    geom_dir = jnp.where(t_near[..., None] > 0.0,
                         geom_dir / jnp.where(norm > 0.0, norm, 1.0), d)
    return entry_uv, geom_dir, hit


def generate_rays(camera: Camera, width: int | None = None, height: int | None = None) -> RayBundle:
    """Generate the per-pixel ray bundle for ``camera`` (optionally overriding size)."""
    w = int(width or camera.width)
    h = int(height or camera.height)
    params = (
        jnp.asarray(camera.position, dtype=jnp.float32),
        jnp.asarray(camera.front, dtype=jnp.float32),
        jnp.asarray(camera.up, dtype=jnp.float32),
        jnp.float32(np.tan(np.radians(camera.fov_y_degrees) * 0.5)),
    )
    entry_uv, direction, hit = _generate_rays(params, w, h)
    return RayBundle(entry_uv=entry_uv, direction=direction, hit=hit)
