"""Phong-shaded isosurface ray march — dense jnp path.

Faithful array-program reimplementation of ``isosurface.frag:77-158``:

* same march setup as the compositing shader (entry at ``vUV``, advance before
  sampling, 300 steps, open-interval bounds exit);
* zero-crossing detection between consecutive samples:
  ``(s - iso) < 0 && (s2 - iso) >= 0`` (``:126``);
* 4-iteration bisection refinement between the bracketing positions
  (``Bisection``, ``:23-42``);
* normal = normalized central difference with ``DELTA = 0.01`` (``:47-62``);
* Phong with headlight (L = V = -geomDir), specular power 250, diffuse color
  (0.39, 0.58, 0.93) (``:69-75, 142-155``);
* pixels with no hit stay white — the shader initializes ``vFragColor`` to
  (255,255,255,1) (``:79``) which the framebuffer saturates to white, matching
  the white clear color for uncovered pixels (``main.cpp:392``).

Fixed iteration counts (4-step bisection, 300-step march) map to unrolled /
bounded loops with latched hit masks.  Like the compositing march, every
function takes its sampler as an argument (``sample_trilinear`` by default,
``sampling.sample_pooled`` for the compressed-domain pool).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .sampling import sample_trilinear

__all__ = ["render_isosurface", "bisection_refine", "gradient_normal", "phong"]

MAX_SAMPLES = 300       # isosurface.frag:15
DELTA = 0.01            # isosurface.frag:18
SPEC_POWER = 250.0      # isosurface.frag:155
DIFFUSE = (0.39, 0.58, 0.93)  # isosurface.frag:155


def bisection_refine(volume, left, right, iso, wrap="clamp",
                     sample=sample_trilinear):
    """4-iteration bisection between ``left`` and ``right`` (``isosurface.frag:23-42``)."""
    for _ in range(4):
        mid = (right + left) * 0.5
        c_m = sample(volume, mid, wrap)
        go_left = (c_m < iso)[..., None]
        left = jnp.where(go_left, mid, left)
        right = jnp.where(go_left, right, mid)
    return (right + left) * 0.5


def gradient_normal(volume, uvw, wrap="clamp", sample=sample_trilinear):
    """Central-difference normal, ``normalize((s1 - s2) / 2)`` (``isosurface.frag:47-62``)."""
    offsets = jnp.eye(3, dtype=jnp.float32) * DELTA
    s1 = jnp.stack(
        [sample(volume, uvw - offsets[i], wrap) for i in range(3)], axis=-1
    )
    s2 = jnp.stack(
        [sample(volume, uvw + offsets[i], wrap) for i in range(3)], axis=-1
    )
    g = (s1 - s2) / 2.0
    norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g / jnp.where(norm > 0, norm, 1.0)


def phong(L, N, V, spec_power=SPEC_POWER, diffuse_color=DIFFUSE):
    """``PhongLighting`` (``isosurface.frag:69-75``)."""
    diffuse = jnp.maximum(jnp.sum(L * N, axis=-1), 0.0)
    half_vec = L + V
    half_vec = half_vec / jnp.linalg.norm(half_vec, axis=-1, keepdims=True)
    spec = jnp.power(jnp.maximum(1e-5, jnp.sum(half_vec * N, axis=-1)), spec_power)
    color = diffuse[..., None] * jnp.asarray(diffuse_color, dtype=jnp.float32) + spec[..., None]
    return color


@partial(jax.jit, static_argnames=("max_samples", "wrap", "sample"))
def render_isosurface(
    volume: jnp.ndarray,
    entry_uv: jnp.ndarray,
    direction: jnp.ndarray,
    hit: jnp.ndarray,
    iso_value: float | jnp.ndarray = 40.0 / 255.0,
    max_samples: int = MAX_SAMPLES,
    wrap: str = "clamp",
    sample=sample_trilinear,
):
    """Returns (rgb (..., 3), hit_mask (...,)).  Non-hit pixels are white.
    ``volume`` is a dense (Z, Y, X) volume or any state with a ``shape``
    that ``sample(volume, uvw, wrap)`` reads."""
    Z, Y, X = volume.shape
    step_size = jnp.array([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=jnp.float32)
    dir_step = direction * step_size
    iso = jnp.asarray(iso_value, dtype=jnp.float32)

    shape = entry_uv.shape[:-1]

    def body(_, state):
        pos, alive, found, hit_near, hit_far = state
        pos = pos + dir_step
        inside = jnp.all((pos > 0.0) & (pos < 1.0), axis=-1)
        alive = alive & inside
        s = sample(volume, pos, wrap)
        s2 = sample(volume, pos + dir_step, wrap)
        crossing = alive & ((s - iso) < 0.0) & ((s2 - iso) >= 0.0) & ~found
        hit_near = jnp.where(crossing[..., None], pos, hit_near)
        hit_far = jnp.where(crossing[..., None], pos + dir_step, hit_far)
        found = found | crossing
        alive = alive & ~found  # the shader breaks out of the loop on a hit
        return pos, alive, found, hit_near, hit_far

    init = (
        entry_uv,
        hit,
        jnp.zeros(shape, dtype=bool),
        jnp.zeros_like(entry_uv),
        jnp.zeros_like(entry_uv),
    )
    # fixed-trip semantics with a global early exit: once every ray has hit or
    # left the cube there is nothing left to march (identical output)
    def cond(state):
        i, st = state
        return (i < max_samples) & jnp.any(st[1])

    def wbody(state):
        i, st = state
        return i + 1, body(i, st)

    _, (_, _, found, hit_near, hit_far) = jax.lax.while_loop(
        cond, wbody, (jnp.int32(0), init))

    tc = bisection_refine(volume, hit_near, hit_far, iso, wrap, sample)
    N = gradient_normal(volume, tc, wrap, sample)
    V = -direction
    color = phong(V, N, V)
    color = jnp.clip(color, 0.0, 1.0)  # framebuffer saturation

    white = jnp.ones(shape + (3,), dtype=jnp.float32)
    rgb = jnp.where(found[..., None], color, white)
    return rgb, found
