"""Front-to-back alpha-compositing ray march — dense jnp path.

Faithful array-program reimplementation of ``raycaster.frag:18-86``:

* rays start at the cube entry point ``vUV`` and advance by
  ``dirStep = geomDir * step_size`` *before* each sample (``:31,39``),
  with ``step_size = (1/X, 1/Y, 1/Z)`` per axis (``main.cpp:330-331``);
* up to ``MAX_SAMPLES = 300`` steps (``:14``);
* bounds exit when any coordinate leaves the open interval (0, 1)
  (the sign-dot test at ``:53`` stops at <= 0 or >= 1);
* compositing: ``prev_alpha = s - s*a; rgb += prev_alpha * s;
  a += prev_alpha * 0.6`` (``:69-72``) — the color is grayscale so a single
  scalar accumulator carries all three channels;
* early termination at ``a > 0.99`` checked *after* compositing (``:77``);
* final fixed transfer: ``g = 1-g; b = 255 (saturates to 1); r = 1-r``
  (``:82-85``).  The GLSL accumulator is uninitialized; in practice it is
  zero, which we make explicit.

Divergence (bounds exit, early out) is handled with latched masks over the
whole ray batch.  The marches take their sampler as a static argument:
``sample_trilinear`` over a dense (Z, Y, X) volume by default, or
``sampling.sample_pooled`` over a compressed-domain ``ShadePool``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .sampling import sample_trilinear

__all__ = ["composite_march", "render_compositing", "MAX_SAMPLES", "ALPHA_SCALE"]

MAX_SAMPLES = 300   # raycaster.frag:14
ALPHA_SCALE = 0.6   # raycaster.frag:72
EARLY_OUT_ALPHA = 0.99  # raycaster.frag:77


@partial(jax.jit, static_argnames=("max_samples", "wrap", "sample"))
def composite_march(
    volume: jnp.ndarray,
    entry_uv: jnp.ndarray,
    direction: jnp.ndarray,
    hit: jnp.ndarray,
    max_samples: int = MAX_SAMPLES,
    wrap: str = "clamp",
    sample=sample_trilinear,
):
    """March rays through ``volume`` (Z, Y, X float32 in [0,1], or any state
    with a ``shape`` that ``sample(volume, uvw, wrap)`` reads).

    Args:
      entry_uv: (..., 3) cube entry points in texture space.
      direction: (..., 3) normalized ray directions (``geomDir``).
      hit: (...) bool mask of rays that intersect the cube.

    Returns:
      (color, alpha): color (..., ) grayscale accumulator Sum(prev_alpha * s)
      and alpha (...,) accumulator, both float32.  Apply
      :func:`apply_reference_transfer` for the displayed RGB.
    """
    Z, Y, X = volume.shape
    step_size = jnp.array([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=jnp.float32)
    dir_step = direction * step_size

    def body(_, state):
        pos, color, alpha, alive = state
        pos = pos + dir_step
        inside = jnp.all((pos > 0.0) & (pos < 1.0), axis=-1)
        alive = alive & inside
        s = sample(volume, pos, wrap)
        prev_alpha = s - s * alpha
        color = jnp.where(alive, color + prev_alpha * s, color)
        alpha = jnp.where(alive, alpha + prev_alpha * ALPHA_SCALE, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
        return pos, color, alpha, alive

    shape = entry_uv.shape[:-1]
    init = (
        entry_uv,
        jnp.zeros(shape, dtype=jnp.float32),
        jnp.zeros(shape, dtype=jnp.float32),
        hit,
    )
    _, color, alpha, _ = jax.lax.fori_loop(0, max_samples, body, init)
    return color, alpha


@partial(jax.jit, static_argnames=("max_samples", "wrap", "sample"))
def composite_march_early_exit(
    volume: jnp.ndarray,
    entry_uv: jnp.ndarray,
    direction: jnp.ndarray,
    hit: jnp.ndarray,
    max_samples: int = MAX_SAMPLES,
    wrap: str = "clamp",
    sample=sample_trilinear,
):
    """Same semantics as :func:`composite_march`, but the fixed-trip loop is a
    ``while_loop`` that stops once *every* ray has terminated (bounds exit or
    alpha saturation).  Bit-identical output; much faster on dense volumes where
    rays saturate in a few tens of steps.  Forward-only (``while_loop`` is not
    reverse-differentiable) — the differentiable path uses the scan in
    ``diff.transfer.render_tf``."""
    Z, Y, X = volume.shape
    step_size = jnp.array([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=jnp.float32)
    dir_step = direction * step_size

    def cond(state):
        i, pos, color, alpha, alive = state
        return (i < max_samples) & jnp.any(alive)

    def body(state):
        i, pos, color, alpha, alive = state
        pos = pos + dir_step
        inside = jnp.all((pos > 0.0) & (pos < 1.0), axis=-1)
        alive = alive & inside
        s = sample(volume, pos, wrap)
        prev_alpha = s - s * alpha
        color = jnp.where(alive, color + prev_alpha * s, color)
        alpha = jnp.where(alive, alpha + prev_alpha * ALPHA_SCALE, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
        return i + 1, pos, color, alpha, alive

    shape = entry_uv.shape[:-1]
    init = (
        jnp.int32(0),
        entry_uv,
        jnp.zeros(shape, dtype=jnp.float32),
        jnp.zeros(shape, dtype=jnp.float32),
        hit,
    )
    _, _, color, alpha, _ = jax.lax.while_loop(cond, body, init)
    return color, alpha


def apply_reference_transfer(color: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """The reference's fixed color transfer (``raycaster.frag:82-85``):
    r = 1 - c, g = 1 - c, b = 255 -> saturates to 1 in the framebuffer."""
    inv = 1.0 - color
    return jnp.stack([inv, inv, jnp.ones_like(color)], axis=-1)


@partial(jax.jit, static_argnames=("max_samples", "wrap", "early_exit",
                                   "sample"))
def render_compositing(
    volume: jnp.ndarray,
    entry_uv: jnp.ndarray,
    direction: jnp.ndarray,
    hit: jnp.ndarray,
    max_samples: int = MAX_SAMPLES,
    wrap: str = "clamp",
    early_exit: bool = True,
    sample=sample_trilinear,
):
    """Full reference pipeline: march + fixed transfer.  Returns (rgb, alpha)
    where rgb is (..., 3) in [0, 1] (background/missed rays come out white,
    matching the white clear color at ``main.cpp:392``)."""
    march = composite_march_early_exit if early_exit else composite_march
    color, alpha = march(volume, entry_uv, direction, hit, max_samples, wrap,
                         sample)
    return apply_reference_transfer(color, alpha), alpha
