"""Multi-device rendering and training via ``shard_map`` over a device mesh.

Replacement for the reference's single-GPU fragment-shader SPMD
(``raycaster.frag`` = one implicit thread per pixel): the image (and its rays)
is sharded over the mesh's ``rays`` axis, each device marches its rows
end-to-end, and gradient reductions ride XLA collectives (``psum``, NCCL
between GPUs) — there is no MPI layer to port (SURVEY.md §2 "Parallelism &
distribution").

Mesh convention: 2-D ``(dp, rays)`` — ``dp`` shards the batch of views/targets
(data parallelism), ``rays`` shards image rows within a view (the renderer's
"sequence/tile" parallelism).  The volume and TF parameters are replicated
here; volume sharding lives in ``context.py`` (1-D z-shards) and
``bricks.py`` (3-D brick shards with halo exchange).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..diff.transfer import TFParams, render_tf

__all__ = ["make_mesh", "render_tf_sharded", "tf_fit_step", "scaling_efficiency_probe"]


def make_mesh(n_devices: int | None = None, dp: int = 1, devices=None) -> Mesh:
    """Create a ``(dp, rays)`` mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % dp == 0, (n_devices, dp)
    grid = np.asarray(devices[:n_devices]).reshape(dp, n_devices // dp)
    return Mesh(grid, axis_names=("dp", "rays"))


def render_tf_sharded(mesh: Mesh, params: TFParams, volume, entry_uv, direction, hit,
                      max_samples: int = 300):
    """Render one view with image rows sharded over the ``rays`` axis."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"), P("rays")),
        check_vma=False,
    )
    def _render(params, volume, entry_uv, direction, hit):
        return render_tf(params, volume, entry_uv, direction, hit, max_samples)

    return _render(params, volume, entry_uv, direction, hit)


def tf_fit_step(mesh: Mesh, params: TFParams, volume, entry_uv, direction, hit,
                target_rgb, lr: float = 1e-2, max_samples: int = 300):
    """One SGD step of the transfer-function fit (BASELINE config 4), sharded:

    * batch of views over ``dp``;
    * image rows over ``rays``;
    * loss/grads all-reduced with ``psum`` over both axes.

    Shapes: entry_uv/direction (B, H, W, 3), hit (B, H, W), target (B, H, W, 3).
    Returns (new_params, loss).
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("dp", "rays"), P("dp", "rays"), P("dp", "rays"),
                  P("dp", "rays")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _step(params, volume, entry_uv, direction, hit, target):
        def local_loss(p):
            rgb, _ = render_tf(p, volume, entry_uv, direction, hit, max_samples)
            # Sum locally; normalize by the global pixel count after psum so the
            # sharded loss equals the unsharded one exactly.
            return jnp.sum((rgb - target) ** 2)

        local, grads = jax.value_and_grad(local_loss)(params)
        total = jax.lax.psum(jax.lax.psum(local, "rays"), "dp")
        grads = jax.tree.map(
            lambda g: jax.lax.psum(jax.lax.psum(g, "rays"), "dp"), grads
        )
        n = np.prod(target.shape).item() * mesh.shape["dp"] * mesh.shape["rays"]
        loss = total / n
        new_params = jax.tree.map(lambda p, g: p - lr * g / n, params, grads)
        return new_params, loss

    return _step(params, volume, entry_uv, direction, hit, target_rgb)


def scaling_efficiency_probe(mesh: Mesh, volume, entry_uv, direction, hit,
                             max_samples: int = 300, frames: int = 4):
    """Render on the full mesh and on a single device; returns the ratio of
    per-device throughputs (>= 0.8 is the north-star target).

    ``frames`` renders are enqueued back-to-back and waited for once with
    ``block_until_ready``."""
    import time

    params = TFParams.reference()

    def bench(m):
        def frame():
            rgb, a = render_tf_sharded(m, params, volume, entry_uv,
                                       direction, hit, max_samples)
            return jnp.sum(rgb) + jnp.sum(a)

        jax.block_until_ready(frame())  # warmup/compile
        t0 = time.perf_counter()
        out = [frame() for _ in range(frames)]
        jax.block_until_ready(out)
        assert np.isfinite(float(sum(out)))
        return (time.perf_counter() - t0) / frames

    t_mesh = bench(mesh)
    t_one = bench(make_mesh(1, devices=list(mesh.devices.flat)))
    n = mesh.devices.size
    return (t_one / n) / t_mesh
