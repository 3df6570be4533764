"""Scalar NumPy transliteration of the reference GLSL pipeline, used as the
test oracle for the jnp/Pallas renderers.

Implements, per pixel with explicit Python loops (float32 throughout):
  * GLM lookAt / perspectiveFov camera and rasterized-front-face ray setup
    (main.cpp:396-397, raycaster.vert:20) via analytic ray/box entry;
  * the compositing march of raycaster.frag:18-86;
  * the isosurface march of isosurface.frag:77-158.

Deliberately written in the most literal style possible (no sharing with the
library code) so it can catch vectorization mistakes.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def normalize(v):
    return (v / np.linalg.norm(v)).astype(f32)


def camera_basis(pos, front, up):
    f = normalize(np.asarray(front, f32))
    s = normalize(np.cross(f, np.asarray(up, f32)))
    u = np.cross(s, f).astype(f32)
    return s, u, f


def pixel_ray(px, py, W, H, fov_y_deg, cam_pos, s, u, f):
    """Ray through pixel center; returns (entry_uv, geom_dir, hit)."""
    tan_half = np.tan(np.radians(fov_y_deg) / 2.0)
    ndc_x = (2.0 * (px + 0.5) / W - 1.0)
    ndc_y = (1.0 - 2.0 * (py + 0.5) / H)
    dx = ndc_x * tan_half * (W / H)
    dy = ndc_y * tan_half
    d = normalize(dx * s + dy * u + f)

    t_near, t_far = -np.inf, np.inf
    for a in range(3):
        if abs(d[a]) < 1e-12:
            if cam_pos[a] < -0.5 or cam_pos[a] > 0.5:
                return None, None, False
            continue
        t0 = (-0.5 - cam_pos[a]) / d[a]
        t1 = (0.5 - cam_pos[a]) / d[a]
        t_near = max(t_near, min(t0, t1))
        t_far = min(t_far, max(t0, t1))
    if not (t_far > max(t_near, 0.0)):
        return None, None, False
    t_entry = max(t_near, 0.0)
    entry = (cam_pos + t_entry * d).astype(f32)
    v_uv = entry + f32(0.5)
    if t_near > 0.0:
        geom_dir = normalize(v_uv - f32(0.5) - cam_pos)
    else:  # eye inside the cube: march from the eye along the pixel ray
        geom_dir = d
    return v_uv, geom_dir, True


def sample_tex(volume_f, uvw, wrap="clamp"):
    """texture(volume, uvw).r — trilinear, GL texel-center convention.
    volume_f: float array (Z, Y, X) already normalized to [0,1]."""
    Z, Y, X = volume_f.shape
    dims = (X, Y, Z)
    uvw = np.asarray(uvw, f32)
    if wrap == "repeat":
        uvw = uvw - np.floor(uvw)
    idx0 = [0, 0, 0]
    idx1 = [0, 0, 0]
    frac = [f32(0)] * 3
    for a in range(3):
        t = uvw[a] * dims[a] - 0.5
        i0 = int(np.floor(t))
        frac[a] = f32(t - i0)
        if wrap == "clamp":
            idx0[a] = min(max(i0, 0), dims[a] - 1)
            idx1[a] = min(max(i0 + 1, 0), dims[a] - 1)
        else:
            idx0[a] = i0 % dims[a]
            idx1[a] = (i0 + 1) % dims[a]

    def V(xi, yi, zi):
        return f32(volume_f[zi, yi, xi])

    fx, fy, fz = frac
    c00 = V(idx0[0], idx0[1], idx0[2]) + (V(idx1[0], idx0[1], idx0[2]) - V(idx0[0], idx0[1], idx0[2])) * fx
    c10 = V(idx0[0], idx1[1], idx0[2]) + (V(idx1[0], idx1[1], idx0[2]) - V(idx0[0], idx1[1], idx0[2])) * fx
    c01 = V(idx0[0], idx0[1], idx1[2]) + (V(idx1[0], idx0[1], idx1[2]) - V(idx0[0], idx0[1], idx1[2])) * fx
    c11 = V(idx0[0], idx1[1], idx1[2]) + (V(idx1[0], idx1[1], idx1[2]) - V(idx0[0], idx1[1], idx1[2])) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return f32(c0 + (c1 - c0) * fz)


def _pixel_list(W, H, pixels):
    if pixels is None:
        return [(py, px) for py in range(H) for px in range(W)]
    return [(int(py), int(px)) for py, px in pixels]


def _shape_out(out, W, H, pixels):
    """Per-pixel results -> (H, W, ...) images, or (n, ...) for a subset."""
    return out if pixels is not None else out.reshape((H, W) + out.shape[1:])


def render_compositing_oracle(volume_u8, W, H, cam_pos=(0, 0, -0.75), front=(0, 0, 1),
                              up=(0, 1, 0), fov=50.0, max_samples=300, wrap="clamp",
                              pixels=None):
    """Returns rgb (H, W, 3) float32 and alpha (H, W); with ``pixels`` (an
    iterable of (row, col)) only those rays, as (n, 3) and (n,)."""
    vol = volume_u8.astype(f32) / f32(255.0)
    Z, Y, X = vol.shape
    step_size = np.array([1.0 / X, 1.0 / Y, 1.0 / Z], f32)
    cam_pos = np.asarray(cam_pos, f32)
    s, u, f = camera_basis(cam_pos, front, up)

    todo = _pixel_list(W, H, pixels)
    rgb = np.ones((len(todo), 3), f32)  # white clear color (main.cpp:392)
    alpha_img = np.zeros((len(todo),), f32)
    for k, (py, px) in enumerate(todo):
        v_uv, geom_dir, ok = pixel_ray(px, py, W, H, fov, cam_pos, s, u, f)
        if not ok:
            continue
        dir_step = geom_dir * step_size
        pos = v_uv.copy()
        c = f32(0.0)
        a = f32(0.0)
        for _ in range(max_samples):
            pos = pos + dir_step
            stop = False
            for ax in range(3):
                if pos[ax] <= 0.0 or pos[ax] >= 1.0:
                    stop = True
            if stop:
                break
            smp = sample_tex(vol, pos, wrap)
            prev_alpha = smp - smp * a
            c = c + prev_alpha * smp
            a = a + prev_alpha * f32(0.6)
            if a > 0.99:
                break
        # transfer: r = 1-c, g = 1-c, b = 255 -> 1
        rgb[k] = (1.0 - c, 1.0 - c, 1.0)
        alpha_img[k] = a
    return _shape_out(rgb, W, H, pixels), _shape_out(alpha_img, W, H, pixels)


def render_isosurface_oracle(volume_u8, W, H, iso=40.0 / 255.0, cam_pos=(0, 0, -0.75),
                             front=(0, 0, 1), up=(0, 1, 0), fov=50.0,
                             max_samples=300, wrap="clamp", pixels=None):
    """Returns rgb (H, W, 3) and hit (H, W); with ``pixels`` only those rays,
    as (n, 3) and (n,)."""
    vol = volume_u8.astype(f32) / f32(255.0)
    Z, Y, X = vol.shape
    step_size = np.array([1.0 / X, 1.0 / Y, 1.0 / Z], f32)
    cam_pos = np.asarray(cam_pos, f32)
    s, u, f = camera_basis(cam_pos, front, up)
    DELTA = f32(0.01)

    todo = _pixel_list(W, H, pixels)
    rgb = np.ones((len(todo), 3), f32)
    hit_img = np.zeros((len(todo),), bool)
    for k, (py, px) in enumerate(todo):
        v_uv, geom_dir, ok = pixel_ray(px, py, W, H, fov, cam_pos, s, u, f)
        if not ok:
            continue
        dir_step = geom_dir * step_size
        pos = v_uv.copy()
        for _ in range(max_samples):
            pos = pos + dir_step
            stop = False
            for ax in range(3):
                if pos[ax] <= 0.0 or pos[ax] >= 1.0:
                    stop = True
            if stop:
                break
            smp = sample_tex(vol, pos, wrap)
            smp2 = sample_tex(vol, pos + dir_step, wrap)
            if (smp - iso) < 0 and (smp2 - iso) >= 0.0:
                left = pos.copy()
                right = pos + dir_step
                for _ in range(4):
                    mid = (right + left) * f32(0.5)
                    if sample_tex(vol, mid, wrap) < iso:
                        left = mid
                    else:
                        right = mid
                tc = (right + left) * f32(0.5)
                s1 = np.array([sample_tex(vol, tc - np.eye(3, dtype=f32)[a] * DELTA, wrap) for a in range(3)], f32)
                s2 = np.array([sample_tex(vol, tc + np.eye(3, dtype=f32)[a] * DELTA, wrap) for a in range(3)], f32)
                N = normalize((s1 - s2) / 2.0)
                V = -geom_dir
                L = V
                diffuse = max(float(np.dot(L, N)), 0.0)
                half_vec = normalize(L + V)
                spec = max(1e-5, float(np.dot(half_vec, N))) ** 250.0
                col = diffuse * np.array([0.39, 0.58, 0.93], f32) + spec
                rgb[k] = np.clip(col, 0.0, 1.0)
                hit_img[k] = True
                break
    return _shape_out(rgb, W, H, pixels), _shape_out(hit_img, W, H, pixels)
