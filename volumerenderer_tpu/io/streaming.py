"""Progressive multi-timestep streaming (BASELINE.json config 5).

The reference loads one timestep, compresses it, and renders it interactively
(``main.cpp:242-290``).  For time-varying data the pipeline overlaps
the three stages across timesteps:

  host I/O (brick files -> dense array)  ->  host/native compression
  (kd-tree build)  ->  device decode + render

A background worker prepares timestep t+1 (load + compress + upload of the
packed tree) while the device renders timestep t; the pipeline is a bounded
queue so at most ``prefetch`` timesteps are in flight.  With the codec's
checkpoint files (``save``/``open``) a stream can resume mid-sequence without
rebuilding (SURVEY.md §5 "Checkpoint / resume").
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

from ..codecs import kdtree as K
from .bricks import BrickGrid, load_bricks

__all__ = ["TimestepStreamer"]


class TimestepStreamer:
    """Iterate (timestep, CompressedRenderer) pairs with background prefetch."""

    def __init__(self, source: Callable, grid: BrickGrid, timesteps: Sequence[int],
                 num_bricks: int, I: int, J: int, K_bricks: int,
                 tolerance: int = 6, max_epochs: int = 2, prefetch: int = 1,
                 cache_dir: str | None = None):
        self.source = source
        self.grid = grid
        self.timesteps = list(timesteps)
        self.shape_args = (num_bricks, I, J, K_bricks)
        self.tolerance = tolerance
        self.max_epochs = max_epochs
        self.cache_dir = cache_dir
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._worker = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    # -- producer (host thread): I/O + compression ------------------------- #

    def _build_one(self, t: int):
        import os

        if self.cache_dir:
            path = os.path.join(self.cache_dir, f"tree_{t:04d}.bin")
            if os.path.exists(path):
                # resume from checkpoint: rebuild the level-structured tree
                # (verified inverse preorder walk) so the resumed timestep
                # keeps the full compressed-renderer path — device decode,
                # cut-depth control, tree-metadata occupancy, slab pools
                try:
                    return ("tree", t, K.open_tree_full(path))
                except ValueError:
                    # unverifiable stream: decode-only dense fallback
                    return ("raw", t, K.open_tree(path))
        num_bricks, I, J, Kb = self.shape_args
        vol = load_bricks(self.source, self.grid, num_bricks, I, J, Kb, t)
        tree = K.build(vol, tolerance=self.tolerance, max_epochs=self.max_epochs)
        if self.cache_dir:
            K.save(tree, os.path.join(self.cache_dir, f"tree_{t:04d}.bin"))
        return ("tree", t, tree)

    def _produce(self):
        try:
            for t in self.timesteps:
                self._q.put(self._build_one(t))
        except Exception as e:  # surface worker failures to the consumer
            self._q.put(("error", -1, e))
        self._q.put(("done", -1, None))

    # -- consumer (device): decode + render -------------------------------- #

    def __iter__(self) -> Iterator:
        from ..models.compressed import CompressedRenderer

        if not self._started:
            self._worker.start()
            self._started = True
        while True:
            kind, t, payload = self._q.get()
            if kind == "done":
                return
            if kind == "error":
                raise payload
            if kind == "raw":
                # resume from checkpoint: decode the serialized stream with the
                # sequential decoder (no rebuild), render dense
                from ..codecs.reference_impl import decode_preorder
                from ..models.compressed import DenseRenderer

                vol = decode_preorder(
                    payload["preorder"], payload["distance_map"],
                    *payload["dims"], payload["orig_depth"],
                    payload["max_depth"], payload["max_depth"])
                yield t, DenseRenderer(vol)
            else:
                yield t, CompressedRenderer(payload)
