"""Fused georeference + regrid: the single-device production fast path.

One jitted step runs the full reference pipeline "forward pass"
(SURVEY.md call stacks 3.1 + 3.2: pixel grid -> TAN unproject -> ray/
ellipsoid intersection -> GEO rotation -> Bowring lat/lon + elevation ->
fixed-grid mean binning). The georef chain and the bin-index arithmetic are
elementwise, so XLA fuses them into the pass that feeds the binning; the
binning is the plain XLA route :func:`auromat_tpu.backend.mean_bin_method`
picks for the device (scatter-add on a GPU, the sorted oracle elsewhere).

Bin-index parity: bin indices come from ops.regrid.bin_indices on the f32
lat/lon chain — identical arithmetic to every XLA binning path. vs the f64
CPU reference, the f32 chain places a pixel within ~4e-5 deg of its f64
position, so only pixels within that band of a 100-arcsec cell edge
(measured ~1.4e-3 of all pixels) can land in the neighbouring cell; each
flip moves one ~uniform sample between two cell means of ~2000 samples
each (<0.1% mean perturbation). Full-precision output (1e-6 deg per-pixel
parity) is the df64 chain in ops.georef. See tests/test_georegrid.py.

Reference: auromat/mapping/astrometry.py:49-212 + auromat/resample.py:
328-351 (the lazy-property pyramid + histogram2d rebin, fused).
"""

import functools

import jax
import jax.numpy as jnp

from auromat_tpu.backend import mean_bin_method
from auromat_tpu.ops.georef import DynGeorefParams, georef_latlon_dyn
from auromat_tpu.ops.regrid import GridSpec, bin_partial, finalize_mean


@functools.partial(jax.jit, static_argnums=(0, 4))
def _georegrid(grid: GridSpec, dyn: DynGeorefParams, img_chw, mask,
               bin_method):
    _, h, w = img_chw.shape
    f32 = jnp.float32

    px = jnp.broadcast_to(jnp.arange(w, dtype=f32)[None, :], (h, w))
    py = jnp.broadcast_to(jnp.arange(h, dtype=f32)[:, None], (h, w))
    out = georef_latlon_dyn(dyn, px, py, dtype=f32, with_elevation=True)
    lat = out["lat"]
    if mask is not None:
        lat = jnp.where(mask, jnp.nan, lat)  # NaN coordinates are invalid
    data = jnp.concatenate([jnp.transpose(img_chw.astype(f32), (1, 2, 0)),
                            out["elevation"][..., None]], axis=-1)
    return bin_partial(grid, lat, out["lon"], data, bin_method)


def georegrid_partial(grid: GridSpec, dyn: DynGeorefParams, img_chw,
                      mask=None, bin_method=None):
    """Fused georef + mean-regrid partial: (count, sums) for one frame.

    :param grid: fixed plate-carree target grid (static)
    :param dyn: per-frame calibration (DynGeorefParams, f32)
    :param img_chw: (3, h, w) image, channels first
    :param mask: optional (h, w) bool, True = exclude pixel
    :param bin_method: an ``ops.regrid._BIN_METHODS`` key; None takes the
        device's route (:func:`auromat_tpu.backend.mean_bin_method`)
    :returns: count (n_lat, n_lon) and sums (n_lat, n_lon, 4) over
        channels (R, G, B, elevation). NaN data at a valid coordinate
        contributes 0 (the ``bin_partial`` contract).
    """
    if bin_method is None:
        bin_method = mean_bin_method()
    return _georegrid(grid, dyn, img_chw, mask, bin_method)


def georegrid_mean(grid: GridSpec, dyn: DynGeorefParams, img_chw,
                   mask=None, bin_method=None):
    """Fused georef + mean regrid: (count, means); NaN where empty."""
    count, sums = georegrid_partial(grid, dyn, img_chw, mask, bin_method)
    return count, finalize_mean(count, sums)
