"""The one place that decides which implementation runs, and where JAX keeps
its compile cache.

The platform of the first JAX device decides:

* ``"gpu"``: the compositing march runs the Pallas kernel compiled through
  Triton (``ops/pallas/raycast_kernel.py``);
* any other platform: XLA compiles the jnp march (``ops/raycast.py``).

The isosurface march, the compressed-domain (pooled) marches, the gradient
paths and the sharded renderers are jnp on every platform.  Nothing here
falls back: a GPU run that cannot compile the kernel fails.
"""
from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["platform", "compositing_impl", "isosurface_impl", "device_info",
           "require_gpu", "card_name_and_power_limit", "compile_cache_dir",
           "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def platform() -> str:
    """``jax.devices()[0].platform`` ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def compositing_impl(platform_name: str | None = None) -> str:
    """"triton" (the Pallas kernel) on a GPU, "xla" (the jnp march)
    elsewhere."""
    p = platform() if platform_name is None else platform_name
    return "triton" if p == "gpu" else "xla"


def isosurface_impl(platform_name: str | None = None) -> str:
    """The isosurface march is jnp on every platform."""
    return "xla"


def device_info() -> dict:
    """Platform, device kind and count, as every measurement line names
    them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``device_info()``; raises when JAX found no GPU.  Measurement scripts
    call this first, so they never time a CPU under a device's name."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {info['platform']} "
                           f"({info['kind']})")
    return info


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints them, one
    line per card, read by a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the cache key includes it)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the path.  Scripts call this before their first compile."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
