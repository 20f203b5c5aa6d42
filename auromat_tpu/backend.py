"""Backend choice, made in one place.

Every dispatch site asks here whether the default JAX backend is a GPU and
which XLA binning route the mean regrid takes on it; nothing else in the
package branches on a platform name.
"""

import os

import jax

# The mean-binning route on a GPU. Every XLA binning variant was timed
# inside the fused f32 step on an H100 (PERF.md, Findings): scatter-add,
# which XLA lowers to atomics, was the fastest on both the 12 MP regional
# grid (540 x 525) and the 0.05 deg global grid (3599 x 7199), so the
# route does not depend on the grid's size.
GPU_BIN_METHOD = "scatter"

# The exact sort-based route: the oracle every other route is compared
# with, and the route on the CPU.
ORACLE_BIN_METHOD = "sorted"


def on_gpu():
    """True when the default JAX backend is a GPU."""
    return jax.default_backend() == "gpu"


def mean_bin_method():
    """The ``ops.regrid._BIN_METHODS`` key the mean regrid uses on the
    default backend."""
    return GPU_BIN_METHOD if on_gpu() else ORACLE_BIN_METHOD


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and no
    other directory is set here. Otherwise the cache lives at the fixed
    path ``<repo>/.jax_cache`` (the path is part of the cache key, so a
    moving directory would never hit).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
