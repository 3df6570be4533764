"""Renderer "model" registry — the reference's shader-selection-by-editing
(``main.cpp:71-75``) becomes an explicit registry of render modes.

``best_renderer()`` and ``best_isosurface_renderer()`` return the
implementation ``backend`` chooses for the current platform;
``reference_renderer()`` always returns the jnp path with exact reference
arithmetic.
"""
from __future__ import annotations

from .. import backend
from ..ops.isosurface import render_isosurface
from ..ops.raycast import MAX_SAMPLES, render_compositing

__all__ = ["reference_renderer", "best_renderer", "best_isosurface_renderer",
           "plan_compositing", "CompositingPlan"]


def reference_renderer():
    return render_compositing


def best_renderer():
    """Compositing renderer with ``render_compositing``'s leading arguments
    (volume, entry_uv, direction, hit, max_samples, wrap)."""
    if backend.compositing_impl() == "triton":
        from ..ops.pallas.raycast_kernel import render_compositing_triton
        return render_compositing_triton
    return render_compositing


def best_isosurface_renderer():
    """Isosurface renderer; same signature as
    ``ops.isosurface.render_isosurface``.  ``backend.isosurface_impl()`` is
    XLA's jnp march on every platform."""
    return render_isosurface


class CompositingPlan:
    """Plan once per camera, render many volumes.  The plan holds the rays
    and the renderer ``backend`` chose; ``render(volume)`` returns
    (rgb, alpha)."""

    def __init__(self, entry_uv, direction, hit, dims,
                 max_samples: int = MAX_SAMPLES):
        self.entry_uv, self.direction, self.hit = entry_uv, direction, hit
        self.dims = tuple(int(d) for d in dims)  # (X, Y, Z)
        self.max_samples = max_samples
        self.impl = backend.compositing_impl()
        self._render = best_renderer()

    def render(self, volume):
        X, Y, Z = self.dims
        if tuple(volume.shape) != (Z, Y, X):
            raise ValueError(f"volume {volume.shape} is not the planned "
                             f"(Z, Y, X) = {(Z, Y, X)}")
        return self._render(volume, self.entry_uv, self.direction, self.hit,
                            self.max_samples)


def plan_compositing(entry_uv, direction, hit, dims,
                     max_samples: int = MAX_SAMPLES) -> CompositingPlan:
    return CompositingPlan(entry_uv, direction, hit, dims, max_samples)
