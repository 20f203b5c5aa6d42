"""Provider burst -> sharded mosaic: the unified config-4/5 production path.

One code path from a mapping provider's frame index to the grid-sharded
mosaic step (VERDICT r3 item 4): bursts of same-shaped frames stream through
``make_grid_sharded_mosaic_step(finalize=False)``, the (count, sums)
partials — which are LINEAR — accumulate across bursts with the row-band
sharding intact, and the mean finalizes once at the end. This replaces the
reference's NuMap host-process throughput loop
(auromat/mapping/spacecraft.py:308-377 feeding cli/convert.py:176-218) with
a device pipeline: georef + binning + reduce-scatter all inside one jit
per burst.

Remainder bursts (sequence length not a multiple of the burst size) are
padded with :func:`null_georef_params` frames — a camera parked 1e9 km above
the north pole looking straight up, so every ray provably misses the
ellipsoid and the frame contributes exactly zero samples. Padding is
therefore EXACT (counts and sums are unchanged), and every burst reuses the
one compiled step instead of recompiling per remainder shape.
"""

import jax
import jax.numpy as jnp
import numpy as np

from auromat_tpu.backend import mean_bin_method
from auromat_tpu.ops.georef import DynGeorefParams, GeorefParams
from auromat_tpu.ops.regrid import GridSpec, finalize_mean
from auromat_tpu.parallel.sharding import (Mesh,
                                           make_grid_sharded_mosaic_step)

_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))

# (mesh, grid, h, w, dtype, bin_method, ...) -> compiled finalize=False step;
# shared across mosaic_sequence calls (see step_for). BOUNDED: compiled
# sharded steps hold whole executables (GB-scale programs at config-5
# grids) — evict least-recently-used beyond a small working set instead
# of growing for every shape/grid/mesh ever seen in the process.
_STEP_CACHE = {}
_STEP_CACHE_MAX = 8


def null_georef_params(like: GeorefParams) -> GeorefParams:
    """A same-shaped frame that contributes NOTHING to any mosaic.

    The camera sits 1e9 km up the +z axis with an identity rotation, so
    every pixel ray points within the (few-degree) field of view of +z —
    directly AWAY from the ellipsoid — and the directed ray-ellipsoid
    intersection misses for all pixels: lat/lon are NaN, every sample is
    invalid, count/sums contributions are exactly zero. Used to pad
    remainder bursts to the compiled batch size.
    """
    return GeorefParams(
        width=like.width, height=like.height, cd=like.cd,
        px_ref=like.px_ref, py_ref=like.py_ref, rotmat=_EYE3,
        camera_pos=(0.0, 0.0, 1.0e9), altitude=like.altitude,
        mat_j2000_to_geo=_EYE3, mat_j2000_to_sm=_EYE3,
    )


def mosaic_sequence(mesh: Mesh, grid: GridSpec, bursts, batch=8,
                    bin_method=None, dtype=jnp.float32,
                    chunk_rows=None, min_elevation=None):
    """Mosaic a whole frame sequence through the grid-sharded step.

    :param bursts: iterable of (params_list, imgs) — same-shaped frame
        groups, e.g. ``SpacecraftMappingProvider.iterParamBursts(...)``.
        ``params_list`` is a list of :class:`GeorefParams`; ``imgs`` is
        (B, h, w, 3) float (0..255 uint8-valued).
        Groups may have ANY length; they are re-chunked/padded to ``batch``.
    :param batch: frames per compiled step call; must divide by mesh dp.
    :param bin_method: ``ops.regrid._BIN_METHODS`` key; None takes the
        device's route (:func:`auromat_tpu.backend.mean_bin_method`)
    :param min_elevation: mask samples below this elevation (degrees)
        BEFORE binning — the per-pixel ``maskedByElevation`` semantics of
        the per-frame convert path, inside the device step.
    :returns: (count, means) GLOBAL jax.Arrays of shape
        (band * n_dev, n_lon[, 4]) sharded row-band-wise over the mesh
        (rows >= grid.n_lat are padding — slice on the host). means
        channels are (R, G, B, elevation).

    One step is compiled per distinct frame shape; all bursts of that shape
    reuse it (remainders padded with zero-contribution null frames).
    """
    dp_n = mesh.shape["dp"]
    if batch % dp_n != 0:
        raise ValueError(f"batch {batch} must divide by mesh dp={dp_n}")

    if bin_method is None:
        bin_method = mean_bin_method()
    total = None  # (count, sums), sharded

    def step_for(h, w):
        # memoized across mosaic_sequence CALLS: a fresh
        # make_grid_sharded_mosaic_step would wrap a fresh jit object and
        # re-trace the whole georef+binning graph every sequence (seconds
        # of host time even with the persistent compile cache warm)
        key = (mesh, grid, h, w, dtype, bin_method, chunk_rows,
               min_elevation)
        if key not in _STEP_CACHE:
            while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.pop(next(iter(_STEP_CACHE)))  # oldest-first
            _STEP_CACHE[key] = make_grid_sharded_mosaic_step(
                mesh, grid, h, w, channels=3, dtype=dtype,
                bin_method=bin_method, chunk_rows=chunk_rows,
                finalize=False, min_elevation=min_elevation)
        else:  # LRU refresh
            _STEP_CACHE[key] = _STEP_CACHE.pop(key)
        return _STEP_CACHE[key]

    @jax.jit
    def _acc(tot, cnt, sums):
        return tot[0] + cnt, tot[1] + sums

    def run_chunk(params, imgs):
        nonlocal total
        h, w = imgs.shape[1:3]
        n = len(params)
        on_device = isinstance(imgs, jax.Array)
        if n < batch:  # pad to the compiled batch size with null frames
            params = list(params) + [null_georef_params(params[0])] * (batch - n)
            if on_device:
                imgs = jnp.concatenate(
                    [imgs, jnp.zeros((batch - n,) + imgs.shape[1:],
                                     imgs.dtype)])
            else:
                imgs = np.concatenate(
                    [imgs, np.zeros((batch - n,) + imgs.shape[1:],
                                    imgs.dtype)])
        dyn = DynGeorefParams.stack(params, dtype=dtype)
        # device-resident imagery passes through WITHOUT a host fetch, but
        # must still be f32 — a second input dtype on the cached step would
        # silently re-trace + recompile the whole graph
        if on_device and imgs.dtype != jnp.float32:
            imgs = imgs.astype(jnp.float32)
        cnt, sums = step_for(h, w)(dyn,
                                   imgs if on_device
                                   else np.asarray(imgs, np.float32))
        total = (cnt, sums) if total is None else _acc(total, cnt, sums)

    for params_list, imgs in bursts:
        params_list = list(params_list)
        if not isinstance(imgs, jax.Array):
            imgs = np.asarray(imgs)
        for i in range(0, len(params_list), batch):
            run_chunk(params_list[i : i + batch], imgs[i : i + batch])

    if total is None:
        raise ValueError("empty sequence: no frames to mosaic")
    count, sums = total
    means = jax.jit(finalize_mean)(count, sums)
    return count, means
