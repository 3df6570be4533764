"""Bricked volume I/O — the equivalent of the reference ``VolumeReader``
(``VolumeReader.h``) and its Richtmyer-Meshkov dataset plumbing
(``main.cpp:580-619``).

The reference loads per-brick raw binary files (uint8, strict size check,
``VolumeReader.h:244-289``) and assembles an I x J x K grid of bricks into one
dense x-fastest array by row-wise copies (``:151-223``).  Here the assembly is
a vectorized block assignment into a (Z, Y, X) NumPy array (memmap-friendly),
with the same brick->(i, j, k) mapping (``fillVolumeBrickMap``,
``main.cpp:599-619``: i fastest, then j, then k) and the same path template
``bob<ttt>/d_<tttt>_<bbbb>`` (``main.cpp:580-597``).

A synthetic brick source generates deterministic bricks so every multi-brick
code path runs without the 3 GB dataset.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np

__all__ = ["BrickGrid", "rm_brick_path", "load_brick_file", "assemble_bricks",
           "load_bricks", "synthetic_brick_source", "file_brick_source",
           "RM_BRICK_DIMS", "RM_VOLUME_GRID"]

RM_BRICK_DIMS = (256, 256, 128)   # (X, Y, Z) per brick, main.cpp:78
RM_VOLUME_GRID = (8, 8, 15)       # (I, J, K) bricks,     main.cpp:79


@dataclasses.dataclass(frozen=True)
class BrickGrid:
    """Brick decomposition of a volume: ``brick_dims`` = (X, Y, Z) cells per
    brick, ``grid`` = (I, J, K) bricks per axis."""

    brick_dims: tuple[int, int, int] = RM_BRICK_DIMS
    grid: tuple[int, int, int] = RM_VOLUME_GRID

    def brick_coords(self, b: int) -> tuple[int, int, int]:
        """brick number -> (i, j, k); i fastest (``fillVolumeBrickMap``)."""
        I, J, K = self.grid
        return (b % I, (b // I) % J, b // (I * J))

    def num_bricks(self) -> int:
        I, J, K = self.grid
        return I * J * K

    def volume_dims(self, I=None, J=None, K=None) -> tuple[int, int, int]:
        """(X, Y, Z) of the assembled volume for a sub-grid (defaults: full)."""
        bi, bj, bk = self.grid
        I, J, K = I or bi, J or bj, K or bk
        bx, by, bz = self.brick_dims
        return (I * bx, J * by, K * bz)


def rm_brick_path(top_dir: str, brick: int, timestep: int) -> str:
    """``bob<ttt>/d_<tttt>_<bbbb>`` (``findBrickBinaryFile``, main.cpp:580-597)."""
    return os.path.join(top_dir, f"bob{timestep:03d}", f"d_{timestep:04d}_{brick:04d}")


def load_brick_file(path: str, brick_dims: tuple[int, int, int],
                    dtype=np.uint8) -> np.ndarray:
    """Read one raw brick file into a (Z, Y, X) array, with the reference's
    strict size check (``VolumeReader.h:253-261``)."""
    X, Y, Z = brick_dims
    expected = X * Y * Z * np.dtype(dtype).itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f"File size does not match expected dataset size: {path} "
            f"has {actual} bytes, expected {expected}")
    data = np.fromfile(path, dtype=dtype)
    return data.reshape(Z, Y, X)  # file is x-fastest


def file_brick_source(top_dir: str, grid: BrickGrid,
                      dtype=np.uint8) -> Callable[[int, int], np.ndarray]:
    """Brick source reading the RM dataset layout from disk."""

    def source(brick: int, timestep: int) -> np.ndarray:
        return load_brick_file(rm_brick_path(top_dir, brick, timestep),
                               grid.brick_dims, dtype)

    return source


def synthetic_brick_source(grid: BrickGrid, kind: str = "turbulence"
                           ) -> Callable[[int, int], np.ndarray]:
    """Deterministic synthetic bricks keyed by (brick, timestep) — globally
    continuous across brick boundaries (each brick samples its own window of
    one world-space field), so compression and rendering behave like real
    data."""
    from .synthetic import turbulence_volume, sphere_volume

    bx, by, bz = grid.brick_dims

    def source(brick: int, timestep: int) -> np.ndarray:
        i, j, k = grid.brick_coords(brick)
        if kind == "sphere":
            I, J, K = grid.grid
            # window of a global sphere centered in the full grid
            center = ((I / 2 - i) / 1, (J / 2 - j), (K / 2 - k))
            return sphere_volume((bz, by, bx),
                                 center=(0.5 + center[2], 0.5 + center[1], 0.5 + center[0]),
                                 radius=1.0, soft=0.5)
        rng_seed = (timestep * 131071 + brick) & 0x7FFFFFFF
        return turbulence_volume((bz, by, bx), seed=rng_seed)

    return source


def assemble_bricks(source: Callable[[int, int], np.ndarray], grid: BrickGrid,
                    num_bricks: int, I: int, J: int, K: int, timestep: int,
                    out: np.ndarray | None = None,
                    workers: int = 1) -> np.ndarray:
    """Assemble ``num_bricks`` bricks into a dense (Z, Y, X) volume — the
    vectorized equivalent of ``LoadBricksToTexture``'s row-copy loops
    (``VolumeReader.h:151-223``).  ``out`` may be a preallocated array or
    memmap for out-of-core assembly.  ``workers`` > 1 reads (or generates)
    bricks on that many threads; each writes its own disjoint block."""
    bx, by, bz = grid.brick_dims
    X, Y, Z = I * bx, J * by, K * bz
    if out is None:
        out = np.zeros((Z, Y, X), dtype=np.uint8)
    assert out.shape == (Z, Y, X), (out.shape, (Z, Y, X))

    def put(b):
        i, j, k = grid.brick_coords(b)
        out[k * bz:(k + 1) * bz, j * by:(j + 1) * by,
            i * bx:(i + 1) * bx] = source(b, timestep)

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(put, range(num_bricks)))
    else:
        for b in range(num_bricks):
            put(b)
    return out


def load_bricks(source, grid: BrickGrid, num_bricks: int, I: int, J: int,
                K: int, timestep: int, workers: int = 1) -> np.ndarray:
    """Reference call shape: ``volume.LoadBricksToTexture(384, 8, 8, 6, 273,
    ...)`` (``main.cpp:242``)."""
    return assemble_bricks(source, grid, num_bricks, I, J, K, timestep,
                           workers=workers)
