"""Astrometric mappings: build a Mapping from a WCS solution + camera state.

The reference's BaseAstrometryMapping lazy pyramid (auromat/mapping/
astrometry.py:18-218) becomes one call into the fused device chain
(auromat_tpu.ops.georef.georeference); MLat/MLT is computed straight from the
J2000 intersections like the reference (astrometry.py:170-198) to minimise
numerical error.
"""

from datetime import datetime

import jax.numpy as jnp
import numpy as np

from auromat_tpu.coordinates.frames import FrameMatrices
from auromat_tpu.coordinates.wcs import TanWcs, make_wcs
from auromat_tpu.mapping.mapping import Mapping
from auromat_tpu.ops.georef import (GeorefParams, georeference,
                                    georeference_generic)


class AstrometryMapping(Mapping):
    """Mapping whose MLat/MLT was computed from the J2000 intersections."""


def _georeference_df64(params: GeorefParams, with_mlatmlt,
                       projection="TAN"):
    """Full-frame georeference through the double-float chain: corner +
    centre grids through ops.georef.georeference_points_df64_full, shaped
    like :func:`ops.georef.georeference`'s output dict (host float64)."""
    from auromat_tpu.ops.georef import _grid, georeference_points_df64_full

    w, h = params.width, params.height
    out = {}
    for corner, suffix in ((True, ""), (False, "_center")):
        px, py = _grid(w, h, corner, jnp.float32)
        # corner elevation is never exported, and mlat/mlt are optional —
        # skip the unused df atan2 branches (the chain is VPU-FLOP-bound)
        d = georeference_points_df64_full(params, px, py,
                                          with_elevation=not corner,
                                          with_mlatmlt=with_mlatmlt,
                                          projection=projection)
        if corner:
            out["lats"], out["lons"] = d["lat"], d["lon"]
        else:
            out["lats_center"], out["lons_center"] = d["lat"], d["lon"]
            out["elevation"] = d["elevation"]
        if with_mlatmlt:
            out["mlat" + suffix] = d["mlat"]
            out["mlt" + suffix] = d["mlt"]
    return out


def create_mapping(wcs_header, img, camera_pos, photo_time: datetime,
                   altitude=110.0, identifier=None, metadata=None,
                   fast_center=True, with_mlatmlt=True, dtype=jnp.float64,
                   frame_matrices=None) -> AstrometryMapping:
    """Georeference an image with a WCS solution into a Mapping.

    TAN headers (every astrometry.net solution) take the fused trig-free
    fast path; any other supported FITS projection (the full Paper II
    catalogue of coordinates.wcs.make_wcs) routes through the generic
    plane->native->celestial chain into the same intersection/Bowring/
    elevation/MLat-MLT pipeline — the reference georeferences such
    headers through its astropy fallback (reference wcs.py:18-64). The
    ``"df64"`` full-precision chain covers the whole zenithal family
    (TAN fused; SIN/ZEA/ARC/STG via the trig-free radial-law forms of
    ops.georef._df_zenithal_dirs).

    :param wcs_header: FITS header dict (astrometry.net .wcs solution)
    :param img: (h, w[, C]) uint8/uint16 image matching IMAGEW/IMAGEH
    :param camera_pos: (3,) GCRS km
    :param fast_center: centre coords as 4-corner means (reference
        fastCenterCalculation, astrometry.py:154-160); mask invariants then
        hold by construction. Ignored by the df64 path (exact centres).
    :param dtype: device compute dtype — float64 for full precision
        (native f64 on the CPU and the GPU), float32 for throughput, or the
        string ``"df64"`` for the double-float chain: full-precision
        (<1e-6 deg) mappings from f32 arithmetic, covering every exported
        per-pixel variable (lat/lon/elevation/MLat/MLT; chip_smoke.py
        checks both on the GPU against the f64 goldens).
    """
    img = np.asarray(img)
    h, w = img.shape[0], img.shape[1]
    try:
        wcs = TanWcs(wcs_header)
    except ValueError:
        wcs = make_wcs(wcs_header)  # any supported FITS projection
        if (wcs_header.get("CTYPE1") or "")[:5] != "RA---":
            # the georef chain reads pixel directions as GCRS~ICRS; a
            # galactic/ecliptic header would be silently mis-framed
            raise ValueError(
                "georeferencing needs an equatorial (RA---/DEC--) WCS; "
                f"got {wcs_header.get('CTYPE1')!r} (use coordinates.wcs."
                "pix2world directly for non-equatorial imagery)")
        if wcs.width is None or wcs.height is None:
            wcs.width, wcs.height = w, h  # non-astrometry.net headers
    assert (w, h) == (wcs.width, wcs.height), ((w, h), (wcs.width, wcs.height))
    fm = frame_matrices or FrameMatrices(photo_time)
    params = GeorefParams.from_wcs(wcs, camera_pos, photo_time, altitude, fm)
    if isinstance(dtype, str) and dtype == "df64":
        projection = getattr(wcs, "projection", None)
        if projection not in ("TAN", "SIN", "ZEA", "ARC", "STG"):
            raise NotImplementedError(
                "the df64 full-precision chain covers the zenithal "
                f"family (TAN/SIN/ZEA/ARC/STG); cannot run a "
                f"{projection} header — use dtype=float64 (CPU parity) "
                "or float32")
        out = _georeference_df64(params, with_mlatmlt, projection)
        fast_center = False  # exact centres; sanitize below
    else:
        if isinstance(wcs, TanWcs):
            out = georeference(params, fast_center=fast_center,
                               with_mlatmlt=with_mlatmlt, dtype=dtype)
        else:
            out = georeference_generic(wcs, params, fast_center=fast_center,
                                       with_mlatmlt=with_mlatmlt,
                                       dtype=dtype)
    get = lambda k: np.array(out[k], dtype=np.float64)  # writable host copy
    mapping = AstrometryMapping(
        get("lats"), get("lons"), get("lats_center"), get("lons_center"),
        get("elevation"), altitude, img, camera_pos, photo_time,
        identifier, metadata=metadata, sanitized=fast_center,
        frame_matrices=fm,
    )
    mapping.wcs_header = wcs_header  # for astrometry diagnostics (draw)
    if with_mlatmlt:
        import numpy.ma as ma

        # align the J2000-derived magnetic coords with the (possibly
        # sanitize-extended) lat/lon masks
        def masked(key, mask):
            a = get(key)
            a[mask] = np.nan
            return ma.masked_invalid(a, copy=False)

        cm, ccm = mapping.corner_mask, mapping.center_mask
        mapping._mlatmlt = (masked("mlat", cm), masked("mlt", cm))
        mapping._mlatmlt_center = (
            masked("mlat_center", ccm), masked("mlt_center", ccm),
        )
    return mapping
