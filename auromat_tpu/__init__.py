"""
auromat_tpu — a JAX/XLA aurora georeferencing framework for accelerators.

A ground-up redesign of the capabilities of ESA's AUROMAT toolkit
(reference: auromat) as device computations, run on an NVIDIA GPU:

* the per-pixel camera->sky->Earth georeferencing chain (WCS TAN projection,
  ray/ellipsoid intersection, frame rotations, Bowring geodetic conversion)
  is a fused, jit-compiled device computation (`auromat_tpu.ops.georef`),
* regridding onto fixed plate-carree grids is device binning
  (`auromat_tpu.ops.regrid`; the route per backend is chosen in
  `auromat_tpu.backend`),
* frame batches `vmap`/`pjit` over `jax.sharding.Mesh` axes
  (`auromat_tpu.parallel`),
* file I/O (FITS/CDF/netCDF/images), TLE ephemeris and star-field solving
  remain thin host-side layers feeding device arrays.

Precision note: the library enables JAX x64 support at import time. Geodetic
parity with the CPU reference (<1e-6 deg) requires float64 in the coordinate
chain: native float64, or float32 with compensated ("double-float")
arithmetic — see `auromat_tpu.ops.dfloat`.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from auromat_tpu import constants  # noqa: E402,F401
