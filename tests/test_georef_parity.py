"""Full-chain parity vs the reference implementation on real ISS frames.

Golden data (tests/resources/golden_georef_*.npz) was produced by running the
reference implementation (auromat.coordinates.{wcs,intersection,transform})
on strided pixel grids of the two checked-in astrometric solutions. Gates:

* direction vectors (TAN unprojection)  < 1e-12
* per-pixel lat/lon                     < 1e-6 deg (north star; actual ~1e-12)
* per-pixel MLat/MLT                    < 1e-6 deg / 1e-7 h
* identical NaN masks (ray misses)
"""

import os

import numpy as np
import pytest

from auromat_tpu.constants import WGS84_A, WGS84_B
from auromat_tpu.coordinates.frames import FrameMatrices
from auromat_tpu.coordinates.intersection import ellipsoid_line_intersection
from auromat_tpu.coordinates.transform import j2000_to_latlon, j2000_to_mlat_mlt
from auromat_tpu.coordinates.wcs import TanWcs, tan_pix2world, tan_pix2world_cartesian
from auromat_tpu.io import fits

RES = os.path.join(os.path.dirname(__file__), "resources")
FRAMES = ["ISS030-E-102170_dc", "ISS029-E-8492"]


@pytest.mark.parametrize("name", FRAMES)
def test_georef_chain_parity(name):
    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    wcs = TanWcs(header)
    shifted = fits.get_shifted_spacecraft_position(header)
    pos = np.array(shifted[:3]) if shifted else np.array(fits.get_spacecraft_position(header))
    np.testing.assert_allclose(pos, golden["camera_pos"])
    photo_time = fits.get_photo_time(header)
    alt = float(golden["altitude"])

    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)

    # 1. TAN unprojection: ra/dec and direction vectors
    ra, dec = tan_pix2world(wcs, px, py)
    np.testing.assert_allclose(np.asarray(ra), golden["ra"], atol=1e-11)
    np.testing.assert_allclose(np.asarray(dec), golden["dec"], atol=1e-11)
    dirs = np.asarray(tan_pix2world_cartesian(wcs, px, py))

    # 2. ray/ellipsoid intersection at emission altitude + 3. frame chain
    inter = np.asarray(
        ellipsoid_line_intersection(WGS84_A + alt, WGS84_B + alt, pos, dirs)
    )
    fm = FrameMatrices(photo_time)
    lat, lon = j2000_to_latlon(inter, fm.j2000_to_geo)
    lat, lon = np.asarray(lat), np.asarray(lon)

    assert np.array_equal(np.isnan(lat), np.isnan(golden["lat"])), "NaN mask mismatch"
    m = ~np.isnan(golden["lat"])
    assert np.abs(lat[m] - golden["lat"][m]).max() < 1e-6
    assert np.abs(lon[m] - golden["lon"][m]).max() < 1e-6

    # 4. MLat/MLT directly from J2000 intersections
    mlat, mlt = j2000_to_mlat_mlt(inter, fm.j2000_to_sm)
    mlat, mlt = np.asarray(mlat), np.asarray(mlt)
    assert np.abs(mlat[m] - golden["mlat"][m]).max() < 1e-6
    assert np.abs(mlt[m] - golden["mlt"][m]).max() < 1e-7


def test_golden_sanity():
    golden = np.load(os.path.join(RES, "golden_georef_ISS030-E-102170_dc.npz"))
    lat = golden["lat"]
    # the aurora in this frame sits over central Canada
    assert 47 < np.nanmin(lat) < 49
    assert 60 < np.nanmax(lat) < 62
    # sky at top of frame, earth at bottom
    assert np.isnan(lat[0]).all()
    assert not np.isnan(lat[-1]).any()


@pytest.mark.parametrize("name", ["ISS030-E-102170_dc"])
def test_df64_chain_parity(name):
    """The double-float chain (f32 pairs, device-executable) must match the
    float64 goldens to <1e-6 deg — the on-hardware parity story
    (SURVEY.md section 7: f64 emulation via double-word arithmetic)."""
    from auromat_tpu.ops.georef import GeorefParams, georeference_points_df64

    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    wcs = TanWcs(header)
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    p = GeorefParams.from_wcs(wcs, pos, fits.get_photo_time(header),
                              float(golden["altitude"]))
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    lat, lon = georeference_points_df64(p, px.astype(np.float32),
                                        py.astype(np.float32))
    ref_lat, ref_lon = golden["lat"], golden["lon"]

    # The only legitimate disagreement region is the horizon: a grazing ray
    # flips between hit/miss under the f32 quantisation of the input pixel
    # grid itself. Quantify that band EXPLICITLY as the hit/miss boundary
    # of the f64 reference (one strided-grid step of dilation) and demand
    # exactness everywhere else: identical masks and max error < 1e-6 deg.
    ref_hit = ~np.isnan(ref_lat)

    def dilate(mask):
        out = mask.copy()
        out[1:] |= mask[:-1]
        out[:-1] |= mask[1:]
        out[:, 1:] |= mask[:, :-1]
        out[:, :-1] |= mask[:, 1:]
        return out

    boundary = dilate(ref_hit & dilate(~ref_hit)) \
        | dilate(~ref_hit & dilate(ref_hit))
    interior = ~boundary
    # the grazing band is a few strided-grid rows around the horizon line
    assert boundary.mean() < 0.10, boundary.mean()
    # away from it: EXACT mask agreement (the north star's "identical
    # NaN/mask semantics")
    assert np.array_equal(np.isnan(lat[interior]), np.isnan(ref_lat[interior]))
    both = interior & ref_hit
    assert both.sum() > 1000
    lat_err = np.abs(lat[both] - ref_lat[both])
    lon_err = np.abs(lon[both] - ref_lon[both])
    assert lat_err.max() < 1e-6, lat_err.max()
    assert lon_err.max() < 1e-6, lon_err.max()
    assert np.median(lat_err) < 2e-8
    # inside the band, hit/miss flips are allowed but must stay rare
    band_agree = (np.isnan(lat[boundary]) == np.isnan(ref_lat[boundary])).mean()
    assert band_agree > 0.95, band_agree


def test_df64_chain_fractional_crpix():
    """astrometry.net solutions typically carry FRACTIONAL CRPIX; the df64
    chain must not collapse the reference pixel to a single f32 (which
    loses ~1e-4 px ~= 1e-6 deg at this scale — 4 orders above the chain's
    accuracy). Gate: <1e-8 deg vs the f64 chain at a perturbed CRPIX
    (measured 8.6e-11 after carrying CRPIX as a df constant; the committed
    test header has integral CRPIX, so the main parity test cannot see
    this)."""
    import dataclasses

    from auromat_tpu.ops.georef import (GeorefParams, georeference_points,
                                        georeference_points_df64)

    name = "ISS030-E-102170_dc"
    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    wcs = TanWcs(header)
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    p = GeorefParams.from_wcs(wcs, pos, fits.get_photo_time(header),
                              float(golden["altitude"]))
    p = dataclasses.replace(p, px_ref=p.px_ref + 0.3748596191406313,
                            py_ref=p.py_ref - 0.2718281828459045)
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    lat64, lon64 = georeference_points(p, px, py)
    lat_df, lon_df = georeference_points_df64(p, px.astype(np.float32),
                                              py.astype(np.float32))
    lat64, lon64 = np.asarray(lat64), np.asarray(lon64)
    both = ~np.isnan(lat64) & ~np.isnan(np.asarray(lat_df))
    assert both.mean() > 0.5
    err = max(np.abs(lat_df[both] - lat64[both]).max(),
              np.abs(lon_df[both] - lon64[both]).max())
    assert err < 1e-8, err


@pytest.mark.parametrize("name", ["ISS030-E-102170_dc"])
def test_df64_full_chain_parity(name):
    """The df64 chain extended over EVERY exported per-pixel variable
    (elevation, MLat, MLT — VERDICT r2 item 3): MLat/MLT gate against the
    reference-generated goldens at <1e-6, elevation (no golden; the
    reference derives it the same way, astrometry.py:200-212) against the
    repo's own validated f64 chain."""
    from auromat_tpu.ops.georef import (GeorefParams,
                                        georeference_points_df64_full,
                                        _pixel_dirs, _intersect,
                                        _elevation_deg)
    import jax.numpy as jnp

    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    wcs = TanWcs(header)
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    p = GeorefParams.from_wcs(wcs, pos, fits.get_photo_time(header),
                              float(golden["altitude"]))
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    out = georeference_points_df64_full(p, px.astype(np.float32),
                                        py.astype(np.float32))

    both = ~np.isnan(golden["mlat"]) & ~np.isnan(out["mlat"])
    assert both.sum() > 1000
    mlat_err = np.abs(out["mlat"][both] - golden["mlat"][both]).max()
    # golden mlt is in HOURS (15 deg/h)
    dm = np.abs(out["mlt"][both] - golden["mlt"][both])
    mlt_err = np.minimum(dm, 24.0 - dm).max()
    assert mlat_err < 1e-6, mlat_err
    assert mlt_err < 1e-7, mlt_err

    # elevation vs the f64 chain
    vx, vy, vz = _pixel_dirs(p, jnp.asarray(px), jnp.asarray(py))
    ix, iy, iz = _intersect(p, vx, vy, vz, jnp.float64)
    elev64 = np.asarray(_elevation_deg(vx, vy, vz, ix, iy, iz))
    b2 = ~np.isnan(elev64) & ~np.isnan(out["elevation"])
    assert b2.sum() > 1000
    elev_err = np.abs(out["elevation"][b2] - elev64[b2]).max()
    assert elev_err < 1e-6, elev_err
