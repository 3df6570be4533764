"""Packed 2-bit / 4-bit code arrays — JAX equivalent of the reference's
``TwoBitArray`` / ``FourBitArray`` containers (reference: ``TwoBitArray.h:30-49``,
``FourBitArray.h:30-49``).

The reference stores 4 two-bit codes per byte, LSB-first: element ``i`` lives in
byte ``i // 4`` at bit position ``(i & 3) * 2`` (``TwoBitArray.h:47-49``).  Here the
same layout is produced/consumed with fully vectorized NumPy / jax.numpy shift-mask
arithmetic, so packed streams round-trip bit-exactly against files written by the
reference while pack/unpack run as single fused XLA ops on device.

Note on ``FourBitArray``: the reference implementation has a latent bug — its
getter masks with ``& 1`` and its setter clears only one bit (``FourBitArray.h:30-39``)
so only the low bit of each nibble survives.  We implement the *intended* 4-bit
semantics (full-nibble mask) and document the deviation here.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "pack2",
    "unpack2",
    "pack2_np",
    "unpack2_np",
    "pack4",
    "unpack4",
    "pack4_np",
    "unpack4_np",
    "packed2_nbytes",
]


def packed2_nbytes(n: int) -> int:
    """Bytes needed for ``n`` 2-bit codes (reference ``TwoBitArray::resize``: (n+3)/4)."""
    return (n + 3) // 4


# --------------------------------------------------------------------------- #
# NumPy (host) versions — used for serialization and the sequential oracle.
# --------------------------------------------------------------------------- #

def pack2_np(codes: np.ndarray) -> np.ndarray:
    """Pack an array of 2-bit codes (values 0..3) into bytes, 4 codes/byte LSB-first."""
    codes = np.asarray(codes, dtype=np.uint8).ravel()
    n = codes.shape[0]
    padded = np.zeros(packed2_nbytes(n) * 4, dtype=np.uint8)
    padded[:n] = codes & 3
    quads = padded.reshape(-1, 4)
    return (
        quads[:, 0]
        | (quads[:, 1] << 2)
        | (quads[:, 2] << 4)
        | (quads[:, 3] << 6)
    ).astype(np.uint8)


def unpack2_np(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    """Unpack bytes into 2-bit codes; returns ``n`` codes (default: 4 * nbytes)."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.shape[0] * 4, dtype=np.uint8)
    out[0::4] = packed & 3
    out[1::4] = (packed >> 2) & 3
    out[2::4] = (packed >> 4) & 3
    out[3::4] = (packed >> 6) & 3
    return out if n is None else out[:n]


def pack4_np(vals: np.ndarray) -> np.ndarray:
    """Pack 4-bit values (0..15) into bytes, 2 values/byte LSB-first (intended
    semantics of the reference FourBitArray)."""
    vals = np.asarray(vals, dtype=np.uint8).ravel()
    n = vals.shape[0]
    padded = np.zeros(((n + 1) // 2) * 2, dtype=np.uint8)
    padded[:n] = vals & 0xF
    pairs = padded.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)


def unpack4_np(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.shape[0] * 2, dtype=np.uint8)
    out[0::2] = packed & 0xF
    out[1::2] = (packed >> 4) & 0xF
    return out if n is None else out[:n]


# --------------------------------------------------------------------------- #
# jax.numpy (device) versions — jit-compatible, vectorized shift/mask.
# Shapes must be static multiples of the packing factor; callers pad.
# --------------------------------------------------------------------------- #

def pack2(codes: jnp.ndarray) -> jnp.ndarray:
    """Device pack: codes (..., 4k) uint8 -> bytes (..., k) uint8."""
    codes = codes.astype(jnp.uint8) & 3
    quads = codes.reshape(codes.shape[:-1] + (-1, 4))
    return (
        quads[..., 0]
        | (quads[..., 1] << 2)
        | (quads[..., 2] << 4)
        | (quads[..., 3] << 6)
    )


def unpack2(packed: jnp.ndarray) -> jnp.ndarray:
    """Device unpack: bytes (..., k) uint8 -> codes (..., 4k) uint8."""
    packed = packed.astype(jnp.uint8)
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = (packed[..., None] >> shifts) & 3
    return codes.reshape(packed.shape[:-1] + (-1,))


def pack4(vals: jnp.ndarray) -> jnp.ndarray:
    vals = vals.astype(jnp.uint8) & 0xF
    pairs = vals.reshape(vals.shape[:-1] + (-1, 2))
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack4(packed: jnp.ndarray) -> jnp.ndarray:
    packed = packed.astype(jnp.uint8)
    shifts = jnp.array([0, 4], dtype=jnp.uint8)
    vals = (packed[..., None] >> shifts) & 0xF
    return vals.reshape(packed.shape[:-1] + (-1,))
