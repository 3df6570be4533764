"""Triton compositing march (ops/pallas/raycast_kernel.py).

On a CPU the kernel runs in the Pallas interpreter and must equal XLA's jnp
march; the ``gpu``-marked test compiles it for the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumerenderer_tpu import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu.io.synthetic import (ramp_volume, sphere_volume,
                                             turbulence_volume)
from volumerenderer_tpu.ops.pallas.raycast_kernel import (
    composite_march_triton, render_compositing_triton)
from volumerenderer_tpu.ops.raycast import composite_march, render_compositing

from fields_and_cameras import CAMERAS, FIELDS


def _interp(vol, rays, max_samples=48, wrap="clamp", **kw):
    return composite_march_triton(vol, rays.entry_uv, rays.direction,
                                  rays.hit, max_samples, wrap,
                                  interpret=True, **kw)


@pytest.mark.parametrize("camera", sorted(CAMERAS))
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_interpret_matches_jnp(field, camera):
    vol = as_normalized_volume(FIELDS[field]((16, 16, 16)))
    rays = generate_rays(CAMERAS[camera](20, 12))
    c_k, a_k = _interp(vol, rays)
    c_r, a_r = composite_march(vol, rays.entry_uv, rays.direction, rays.hit,
                               48)
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_r), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_k), np.asarray(a_r), atol=1e-6)


@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (16, 16), (20, 33)])
def test_ragged_tiles_cover_every_pixel(hw):
    """Images that are not a multiple of the tile: every pixel is written
    with its own ray's value (no NaN, no neighbor's value)."""
    h, w = hw
    vol = as_normalized_volume(turbulence_volume((12, 16, 20), seed=2))
    rays = generate_rays(Camera(width=w, height=h, position=(0.2, 0.1, -0.8),
                                front=(-0.2, -0.1, 1.0)))
    c_k, a_k = _interp(vol, rays)
    c_r, a_r = composite_march(vol, rays.entry_uv, rays.direction, rays.hit,
                               48)
    assert c_k.shape == (h, w) and np.isfinite(np.asarray(c_k)).all()
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_r), atol=1e-6)


@pytest.mark.parametrize("max_samples", [1, 7, 300])
def test_step_budget_matches_jnp(max_samples):
    """The per-tile loop stops at ``max_samples`` like the jnp march."""
    vol = as_normalized_volume(sphere_volume((16, 16, 16))) * 0.2
    rays = generate_rays(Camera(width=24, height=20))
    c_k, a_k = _interp(vol, rays, max_samples=max_samples)
    c_r, a_r = composite_march(vol, rays.entry_uv, rays.direction, rays.hit,
                               max_samples)
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_r), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_k), np.asarray(a_r), atol=1e-6)


def test_repeat_wrap_matches_jnp():
    vol = as_normalized_volume(ramp_volume((16, 12, 8), axis=1))
    rays = generate_rays(Camera(width=13, height=11))
    c_k, a_k = _interp(vol, rays, wrap="repeat")
    c_r, a_r = composite_march(vol, rays.entry_uv, rays.direction, rays.hit,
                               48, "repeat")
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_r), atol=1e-6)


def test_flat_and_batched_ray_shapes():
    """Rays of any leading shape march as a 2-D image of their last axis."""
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=4))
    rays = generate_rays(Camera(width=8, height=6))
    e, d, h = rays.entry_uv, rays.direction, rays.hit
    c2, _ = composite_march_triton(vol, e, d, h, 48, interpret=True)
    c1, _ = composite_march_triton(vol, e.reshape(-1, 3), d.reshape(-1, 3),
                                   h.reshape(-1), 48, interpret=True)
    c3, _ = composite_march_triton(vol, e[None], d[None], h[None], 48,
                                   interpret=True)
    np.testing.assert_array_equal(np.asarray(c1).reshape(6, 8),
                                  np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(c3)[0], np.asarray(c2))


def test_unknown_wrap_rejected():
    vol = jnp.zeros((8, 8, 8), jnp.float32)
    rays = generate_rays(Camera(width=4, height=4))
    with pytest.raises(ValueError):
        _interp(vol, rays, wrap="mirror")


@pytest.mark.gpu
def test_kernel_on_gpu_matches_jnp(gpu):
    """Compiled for the card: the Triton march against XLA's jnp march at
    the headline shape."""
    vol = as_normalized_volume(turbulence_volume((256, 256, 256), seed=0))
    rays = generate_rays(Camera(width=1024, height=1024))
    rgb_k, a_k = render_compositing_triton(vol, rays.entry_uv,
                                           rays.direction, rays.hit)
    rgb_r, a_r = render_compositing(vol, rays.entry_uv, rays.direction,
                                    rays.hit)
    d = np.abs(np.asarray(rgb_k) - np.asarray(rgb_r)).max(axis=-1)
    assert float(np.quantile(d, 0.9999)) <= 2e-4
    assert jax.devices()[0].platform == "gpu"
