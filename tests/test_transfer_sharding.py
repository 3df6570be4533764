"""Tests for the differentiable TF renderer and shard_map distribution:
N-shard output must equal 1-shard output (SURVEY.md §4 "Distributed")."""
import jax
import jax.numpy as jnp
import numpy as np

from volumerenderer_tpu import Camera, generate_rays, as_normalized_volume
from volumerenderer_tpu.io.synthetic import sphere_volume
from volumerenderer_tpu.ops.raycast import render_compositing
from volumerenderer_tpu.diff.transfer import TFParams, render_tf, tf_loss
from volumerenderer_tpu.parallel.sharding import make_mesh, render_tf_sharded, tf_fit_step

W, H = 16, 16


def _setup():
    vol = as_normalized_volume(sphere_volume((16, 16, 16)))
    rays = generate_rays(Camera(width=W, height=H))
    return vol, rays


def test_tf_reference_params_match_reference_renderer():
    vol, rays = _setup()
    rgb_ref, _ = render_compositing(vol, rays.entry_uv, rays.direction, rays.hit)
    rgb_tf, _ = render_tf(TFParams.reference(), vol, rays.entry_uv, rays.direction, rays.hit)
    np.testing.assert_allclose(np.asarray(rgb_tf), np.asarray(rgb_ref), atol=1e-6)


def test_tf_gradients_finite_difference():
    # Keep alpha below the 0.99 early-out threshold for every ray: the
    # termination mask is the only parameter-dependent control flow, so in this
    # regime the loss is smooth and finite differences must match.
    vol, rays = _setup()
    vol = vol * 0.2
    target = jnp.zeros((H, W, 3), dtype=jnp.float32)
    params = TFParams.reference()

    loss_fn = lambda p: tf_loss(p, vol, rays.entry_uv, rays.direction, rays.hit,
                                target, max_samples=16)
    g = jax.grad(loss_fn)(params)

    eps = 1e-3
    for field in ["alpha_scale", "color_gain"]:
        p_plus = params._replace(**{field: getattr(params, field) + eps})
        p_minus = params._replace(**{field: getattr(params, field) - eps})
        fd = (loss_fn(p_plus) - loss_fn(p_minus)) / (2 * eps)
        an = float(getattr(g, field))
        assert abs(an - float(fd)) < 5e-3 * max(1.0, abs(float(fd))), (field, an, float(fd))


def test_volume_gradients_flow():
    vol, rays = _setup()
    target = jnp.zeros((H, W, 3), dtype=jnp.float32)

    def loss_on_volume(v):
        return tf_loss(TFParams.reference(), v, rays.entry_uv, rays.direction,
                       rays.hit, target, max_samples=32)

    g = jax.grad(loss_on_volume)(vol)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0


def test_sharded_render_matches_single_device():
    vol, rays = _setup()
    params = TFParams.reference()
    rgb_single, a_single = render_tf(params, vol, rays.entry_uv, rays.direction, rays.hit)

    mesh = make_mesh(8, dp=1)
    rgb_sharded, a_sharded = render_tf_sharded(mesh, params, vol, rays.entry_uv,
                                               rays.direction, rays.hit)
    np.testing.assert_allclose(np.asarray(rgb_sharded), np.asarray(rgb_single), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_sharded), np.asarray(a_single), atol=1e-6)


def test_tf_fit_step_sharded_matches_unsharded_grads():
    vol, rays = _setup()
    params = TFParams.reference()
    B = 2
    batch = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    entry_uv, direction, hit = batch(rays.entry_uv), batch(rays.direction), batch(rays.hit)
    target = jnp.full((B, H, W, 3), 0.5, dtype=jnp.float32)

    mesh8 = make_mesh(8, dp=2)
    p8, loss8 = tf_fit_step(mesh8, params, vol, entry_uv, direction, hit, target,
                            max_samples=32)
    mesh1 = make_mesh(1, dp=1)
    p1, loss1 = tf_fit_step(mesh1, params, vol, entry_uv, direction, hit, target,
                            max_samples=32)
    assert abs(float(loss8) - float(loss1)) < 1e-6
    for a, b in zip(jax.tree.leaves(p8), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_scaling_efficiency_probe_runs():
    """The scaling harness executes on the CPU mesh: returns a finite positive
    ratio.  (CPU-mesh timings carry no scaling signal; this pins the harness
    so real multi-chip runs are turnkey.)"""
    from volumerenderer_tpu.parallel.sharding import (make_mesh,
                                                      scaling_efficiency_probe)

    vol, rays = _setup()
    mesh = make_mesh(4)
    eff = scaling_efficiency_probe(mesh, vol, rays.entry_uv, rays.direction,
                                   rays.hit, max_samples=16, frames=2)
    assert np.isfinite(eff) and eff > 0.0


def test_measure_scaling_efficiency_runs():
    """multihost.measure_scaling_efficiency drives render fns over mesh sizes
    and reports per-device efficiency ratios."""
    from volumerenderer_tpu.parallel.multihost import measure_scaling_efficiency
    from volumerenderer_tpu.parallel.sharding import make_mesh, render_tf_sharded
    from volumerenderer_tpu.diff.transfer import TFParams

    vol, rays = _setup()
    params = TFParams.reference()
    meshes = {n: make_mesh(n) for n in (1, 2, 4)}

    def render_fn(n):
        rgb, a = render_tf_sharded(meshes[n], params, vol, rays.entry_uv,
                                   rays.direction, rays.hit, max_samples=16)
        return float(jnp.sum(rgb) + jnp.sum(a))  # forced 4-byte transfer

    res = measure_scaling_efficiency(render_fn, (1, 2, 4), reps=2)
    assert set(res) == {1, 2, 4}
    for n, (dt, eff) in res.items():
        assert dt > 0 and np.isfinite(eff)
