"""Shared small test fields and cameras for the renderer tests."""
import numpy as np

from volumerenderer_tpu import Camera, orbit_camera
from volumerenderer_tpu.io.synthetic import (ramp_volume, sphere_volume,
                                             turbulence_volume)


def _shell(shape):
    """A thin spherical shell: 255 within 0.04 of radius 0.3, else 0."""
    Z, Y, X = shape
    z, y, x = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in (Z, Y, X)],
                          indexing="ij")
    d = np.sqrt((z - 0.5) ** 2 + (y - 0.5) ** 2 + (x - 0.5) ** 2)
    return np.where(np.abs(d - 0.3) < 0.04, 255, 0).astype(np.uint8)


FIELDS = {
    "sphere": sphere_volume,
    "ramp": ramp_volume,
    "turbulence": lambda shape: turbulence_volume(shape, seed=5),
    "empty": lambda shape: np.zeros(shape, np.uint8),
    "shell": _shell,
}

CAMERAS = {
    "default": lambda w, h: Camera(width=w, height=h),
    "orbit": lambda w, h: orbit_camera(35.0, w, h),
    "axis": lambda w, h: Camera(width=w, height=h, position=(-0.9, 0.0, 0.0),
                                front=(1.0, 0.0, 0.0)),
    "grazing": lambda w, h: Camera(width=w, height=h,
                                   position=(0.0, 0.49, -0.9),
                                   front=(0.0, -0.02, 1.0)),
    "inside": lambda w, h: Camera(width=w, height=h,
                                  position=(0.1, -0.1, 0.05),
                                  front=(0.3, 0.2, 1.0)),
}
