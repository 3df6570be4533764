"""Compressed-volume renderer: device-side level-cut decode feeding the ray
march — the working realization of the reference's unfinished compressed-domain
path (``isosurface_compressed.frag`` outputs constant gray; ``main.cpp:203-237``
upload paths are commented out).  Here decode + render both run on device:
HBM-resident packed codes -> dense level-cut volume -> march, with the decode
jit-fused and the dense volume cacheable across frames per cut depth.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..codecs.device import level_cut_device, to_device, tree_occupancy_mip8
from ..ops.isosurface import render_isosurface
from ..ops.raycast import MAX_SAMPLES, render_compositing
from ..ops.sampling import as_normalized_volume, sample_pooled

__all__ = ["CompressedRenderer", "DenseRenderer"]


def _render(vol, rays, mode: str, **kwargs):
    """Render ``vol`` with the renderer ``backend`` chooses for ``mode``."""
    from . import best_isosurface_renderer, best_renderer

    if mode == "compositing":
        return best_renderer()(vol, rays.entry_uv, rays.direction, rays.hit,
                               **kwargs)
    elif mode == "isosurface":
        return best_isosurface_renderer()(vol, rays.entry_uv, rays.direction,
                                          rays.hit, **kwargs)
    raise ValueError(f"unknown mode {mode}")


class DenseRenderer:
    """Same render API over an uncompressed (Z, Y, X) volume (e.g. decoded
    from a checkpoint file without rebuilding the tree)."""

    def __init__(self, volume):
        self._vol = as_normalized_volume(volume)

    def volume_at(self, cut_depth=None):
        return self._vol

    def render(self, rays, cut_depth=None, mode: str = "compositing", **kwargs):
        return _render(self._vol, rays, mode, **kwargs)


class CompressedRenderer:
    """Render directly from a compressed kd-tree.

    The decoded level cut is cached per cut depth (the reference decodes once
    and re-uploads the texture, ``main.cpp:280-290``; we keep everything in
    HBM).  Progressive refinement = rendering coarser cuts first.
    """

    def __init__(self, tree):
        # accepts a KdTree or a MidRangeTree (decodes its midpoint channel,
        # exactly as the reference levelCut does, MidRangeTree.cpp:984-1093)
        if hasattr(tree, "mid"):
            tree = tree.mid
        self.tree = tree
        self.dtree, self.spec = to_device(tree)
        self._cache: dict[int, jnp.ndarray] = {}
        self._pool_cache: dict[int, object] = {}
        self._mip_cache: dict[int, jnp.ndarray] = {}

    # per-(tree spec, cut) memo: once a device decode of THIS shape ran out
    # of memory in this process, later decodes of the same shape go straight
    # to the host path — other trees/cuts are unaffected
    _device_decode_broken: dict = {}

    def _spec_key(self, cut: int):
        return (tuple(self.spec["dims"]), self.spec["orig_depth"],
                self.spec["max_depth"], self.spec["chain_len"], cut)

    def _decoded(self, cut: int):
        """Level-cut decode with a host fallback for one cause only: the
        device running out of memory (``RESOURCE_EXHAUSTED``) on a very
        deep/low-tolerance tree — the vectorized HOST decode produces
        identical bytes.  Every other failure of the device decode
        propagates."""
        key = self._spec_key(cut)
        if not CompressedRenderer._device_decode_broken.get(key):
            try:
                return level_cut_device(self.dtree, self.spec, cut)
            except Exception as e:  # noqa: BLE001 — filtered below
                msg = f"{type(e).__name__}: {e}"
                if "RESOURCE_EXHAUSTED" not in msg:
                    raise
                import warnings

                warnings.warn(
                    f"device level-cut decode ran out of memory for spec "
                    f"{key} ({msg.splitlines()[0][:200]}); falling back to "
                    f"the host decode for this tree shape", stacklevel=2)
                CompressedRenderer._device_decode_broken[key] = True
        from ..codecs.kdtree import level_cut

        return level_cut(self.tree, cut)

    def decoded_on_device(self, cut_depth: int | None = None) -> bool:
        """False once a device decode of this tree shape ran out of memory
        and the host decode served it."""
        cut = self.spec["max_depth"] if cut_depth is None else int(cut_depth)
        return not CompressedRenderer._device_decode_broken.get(
            self._spec_key(cut), False)

    def volume_at(self, cut_depth: int | None = None) -> jnp.ndarray:
        cut = self.spec["max_depth"] if cut_depth is None else int(cut_depth)
        if cut not in self._cache:
            self._cache[cut] = as_normalized_volume(self._decoded(cut))
        return self._cache[cut]

    def mip8_at(self, cut_depth: int | None = None) -> jnp.ndarray:
        """Per-8³-block maxima of the level cut from tree metadata alone."""
        cut = self.spec["max_depth"] if cut_depth is None else int(cut_depth)
        if cut not in self._mip_cache:
            self._mip_cache[cut] = tree_occupancy_mip8(self.dtree, self.spec,
                                                       cut)
        return self._mip_cache[cut]

    def shade_pool_at(self, cut_depth: int | None = None):
        """Sparse packed-neighborhood state of the level cut
        (``ops.sampling.ShadePool``): only z-slabs the tree says are
        occupied stay resident, with residency from tree metadata
        (``tree_occupancy_mip8``, no dense pass).  The dense decode is
        transient inside the pool build."""
        cut = self.spec["max_depth"] if cut_depth is None else int(cut_depth)
        if cut not in self._pool_cache:
            from ..ops.sampling import build_shade_pool

            decoded = self._decoded(cut)
            self._pool_cache[cut] = build_shade_pool(
                as_normalized_volume(decoded), mip8=self.mip8_at(cut))
            del decoded
        return self._pool_cache[cut]

    def render(self, rays, cut_depth: int | None = None,
               mode: str = "compositing", **kwargs):
        """Render the level cut with the renderer ``backend`` chooses
        (``models.best_renderer`` / ``best_isosurface_renderer``)."""
        return _render(self.volume_at(cut_depth), rays, mode, **kwargs)

    def diff_decoder(self, cut_depth: int | None = None):
        """Differentiable view of this tree (``codecs.diff.DiffDecoder``):
        ``dec(dm, leaf_adjust)`` -> (Z, Y, X) f32 volume in [0, 1] with a
        custom VJP routing image-loss gradients to the per-depth Δ map and
        the per-leaf scalars (BASELINE north star; SURVEY.md §7
        "Differentiability")."""
        from ..codecs.diff import DiffDecoder

        return DiffDecoder(self.dtree, self.spec, cut_depth=cut_depth)

    def make_plan(self, rays, cut_depth: int | None = None,
                  mode: str = "compositing",
                  iso_value: float = 40.0 / 255.0,
                  max_samples: int = MAX_SAMPLES, pooled: bool = False):
        """Plan-once / render-many over this tree's level cut.  Returns a
        zero-argument callable producing the same (rgb, alpha-or-hit) as
        :meth:`render`.

        ``pooled=False`` renders the dense decoded cut through the renderer
        ``backend`` chooses.  ``pooled=True`` is the compressed-domain
        render, our redesign of the reference's unfinished in-shader tree
        traversal (``isosurface_compressed.frag:18-44``): the resident
        volume state is the packed tree plus the sparse occupied-slab pool
        (:meth:`shade_pool_at`), never a dense volume, and both marches
        sample it with ``sample_pooled`` (XLA on every platform).  Samples
        are 8-bit exact, so pooled and dense agree to float rounding."""
        if mode not in ("compositing", "isosurface"):
            raise ValueError(f"unknown mode {mode}")
        if pooled:
            state = self.shade_pool_at(cut_depth)
            if mode == "compositing":
                return lambda: render_compositing(
                    state, rays.entry_uv, rays.direction, rays.hit,
                    max_samples, sample=sample_pooled)
            return lambda: render_isosurface(
                state, rays.entry_uv, rays.direction, rays.hit, iso_value,
                max_samples, sample=sample_pooled)
        vol = self.volume_at(cut_depth)
        if mode == "compositing":
            from . import CompositingPlan

            plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit,
                                   self.spec["dims"], max_samples)
            return lambda: plan.render(vol)
        return lambda: _render(vol, rays, "isosurface", iso_value=iso_value,
                               max_samples=max_samples)
