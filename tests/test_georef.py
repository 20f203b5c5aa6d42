"""Fused georeference op tests: parity with goldens + internal consistency."""

import os

import numpy as np
import pytest

from auromat_tpu.coordinates.wcs import TanWcs
from auromat_tpu.io import fits
from auromat_tpu.ops.georef import GeorefParams, georeference, georeference_points

RES = os.path.join(os.path.dirname(__file__), "resources")


def _params(name="ISS030-E-102170_dc", altitude=110.0):
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    wcs = TanWcs(header)
    shifted = fits.get_shifted_spacecraft_position(header)
    pos = shifted[:3] if shifted else fits.get_spacecraft_position(header)
    # deliberately the RAW DATE-OBS: the committed golden_georef grids
    # were generated with this pairing — these tests pin KERNEL parity
    # for stated inputs (production pairs the SHIFTED photo time,
    # spacecraft.resolve_camera_position; gated by the end-to-end
    # resample goldens)
    return GeorefParams.from_wcs(wcs, pos, fits.get_photo_time(header), altitude)


@pytest.mark.parametrize("name", ["ISS030-E-102170_dc", "ISS029-E-8492"])
def test_fused_chain_matches_reference_goldens(name):
    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    p = _params(name, float(golden["altitude"]))
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    lat, lon = georeference_points(p, px, py)
    lat, lon = np.asarray(lat), np.asarray(lon)
    assert np.array_equal(np.isnan(lat), np.isnan(golden["lat"]))
    m = ~np.isnan(golden["lat"])
    assert np.abs(lat[m] - golden["lat"][m]).max() < 1e-6
    assert np.abs(lon[m] - golden["lon"][m]).max() < 1e-6


def test_full_frame_georeference_shapes_and_masks():
    p = _params()
    out = georeference(p, fast_center=True)
    h, w = p.height, p.width
    assert np.asarray(out["lats"]).shape == (h + 1, w + 1)
    assert np.asarray(out["lats_center"]).shape == (h, w)
    assert np.asarray(out["elevation"]).shape == (h, w)
    assert np.asarray(out["mlat"]).shape == (h + 1, w + 1)

    lats = np.asarray(out["lats"])
    lats_c = np.asarray(out["lats_center"])
    # sky at top, earth at bottom (reference intersection_test semantics)
    assert np.isnan(lats[0, w // 2]) and not np.isnan(lats[-1, w // 2])
    # fast centres: centre defined iff all 4 corners defined
    corner_ok = ~np.isnan(lats)
    all4 = corner_ok[:-1, :-1] & corner_ok[:-1, 1:] & corner_ok[1:, :-1] & corner_ok[1:, 1:]
    assert np.array_equal(~np.isnan(lats_c), all4)
    # masks consistent across outputs
    assert np.array_equal(np.isnan(lats_c), np.isnan(np.asarray(out["elevation"])))
    assert np.array_equal(np.isnan(lats), np.isnan(np.asarray(out["mlat"])))

    elev = np.asarray(out["elevation"])
    e = elev[~np.isnan(elev)]
    assert e.min() > -90 and e.max() <= 90
    # the horizon is visible in this frame -> elevations near 0 exist
    assert e.min() < 1.0
    assert e.max() > 10.0


def test_exact_centers_close_to_fast_centers():
    p = _params()
    exact = georeference(p, fast_center=False, with_mlatmlt=False)
    fast = georeference(p, fast_center=True, with_mlatmlt=False)
    lc_e = np.asarray(exact["lats_center"])
    lc_f = np.asarray(fast["lats_center"])
    both = ~np.isnan(lc_e) & ~np.isnan(lc_f)
    # interior pixels: corner-mean approximation is sub-pixel accurate
    d = np.abs(lc_e[both] - lc_f[both])
    assert np.median(d) < 1e-4


def test_mlat_mlt_ranges():
    p = _params()
    out = georeference(p, fast_center=True)
    mlat = np.asarray(out["mlat"])
    mlt = np.asarray(out["mlt"])
    m = ~np.isnan(mlat)
    assert mlat[m].min() > -90 and mlat[m].max() < 90
    assert mlt[m].min() >= 0 and mlt[m].max() <= 24
    # winter-evening aurora over Canada: high magnetic latitude
    assert 55 < np.nanmean(mlat) < 75


def test_altitude_monotonic():
    # higher emission altitude -> intersections further along the ray ->
    # footprint shifts; the unmasked area must grow (larger inflated earth)
    p90 = _params(altitude=90.0)
    p150 = _params(altitude=150.0)
    px, py = np.meshgrid(np.linspace(0, 4255, 60), np.linspace(0, 2831, 40))
    lat90, _ = georeference_points(p90, px, py)
    lat150, _ = georeference_points(p150, px, py)
    n90 = np.isnan(np.asarray(lat90)).sum()
    n150 = np.isnan(np.asarray(lat150)).sum()
    assert n150 < n90


def test_float32_chain_accuracy():
    """f32 end-to-end: documents the precision floor that motivates the
    compensated df64 path (~1e-3..1e-2 deg vs f64)."""
    import jax.numpy as jnp

    golden = np.load(os.path.join(RES, "golden_georef_ISS030-E-102170_dc.npz"))
    p = _params(altitude=float(golden["altitude"]))
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    lat, lon = georeference_points(p, px.astype(np.float32), py.astype(np.float32),
                                   dtype=jnp.float32)
    lat = np.asarray(lat)
    m = ~np.isnan(golden["lat"]) & ~np.isnan(lat)
    assert m.mean() > 0.5
    err = np.abs(lat[m] - golden["lat"][m])
    assert np.median(err) < 0.05  # f32 is coarse; parity requires f64/df64


@pytest.mark.slow
def test_create_mapping_df64_full_precision():
    """dtype='df64' builds a full-precision PRODUCTION mapping through the
    double-float chain — the device-resident full-precision export path
    from f32 arithmetic. Gate: every mapping
    variable within 1e-6 (measured ~1e-10) of the f64 chain with matching
    masks."""
    import jax.numpy as jnp

    from auromat_tpu.io import fits
    from auromat_tpu.mapping.astrometry import create_mapping

    h = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    scale = 32  # downscaled frame: full 12 MP df on CPU is minutes
    hdr = dict(h)
    hdr["IMAGEW"] = int(h["IMAGEW"]) // scale
    hdr["IMAGEH"] = int(h["IMAGEH"]) // scale
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        hdr[k] = float(h[k]) * scale
    hdr["CRPIX1"] = float(h["CRPIX1"]) / scale
    hdr["CRPIX2"] = float(h["CRPIX2"]) / scale
    img = np.zeros((hdr["IMAGEH"], hdr["IMAGEW"], 3), np.uint8)
    pos = np.array(fits.get_shifted_spacecraft_position(h)[:3])
    t = fits.get_photo_time(h)

    m64 = create_mapping(hdr, img, pos, t, dtype=jnp.float64,
                         fast_center=False)
    mdf = create_mapping(hdr, img, pos, t, dtype="df64")
    mdf.checkGuarantees()
    for attr in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        a = np.asarray(getattr(m64, attr).filled(np.nan), dtype=np.float64)
        b = np.asarray(getattr(mdf, attr).filled(np.nan), dtype=np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), attr
        s = ~np.isnan(a)
        assert s.sum() > 1000
        assert np.abs(a[s] - b[s]).max() < 1e-6, attr
    for pair64, pairdf in ((m64.mLatMlt, mdf.mLatMlt),
                           (m64.mLatMltCenter, mdf.mLatMltCenter)):
        for a_, b_ in zip(pair64, pairdf):
            a = np.asarray(a_.filled(np.nan), dtype=np.float64)
            b = np.asarray(b_.filled(np.nan), dtype=np.float64)
            s = ~np.isnan(a) & ~np.isnan(b)
            assert s.sum() > 1000
            assert np.abs(a[s] - b[s]).max() < 1e-6


class TestGenericProjectionGeoref:
    """Non-TAN headers through create_mapping — the reference's
    astropy-fallback georeferencing role (reference wcs.py:18-64 via
    astrometry.py:49-64), here first-party via georeference_generic."""

    @staticmethod
    def _mapping_for(code, dtype=np.float64, crop=None, **pv):
        from auromat_tpu.io.image import load_image
        from auromat_tpu.mapping.astrometry import create_mapping

        header = dict(fits.read_header(
            os.path.join(RES, "ISS030-E-102170_dc.wcs")))
        header["CTYPE1"] = f"RA---{code}"
        header["CTYPE2"] = f"DEC--{code}"
        header.update(pv)
        img = load_image(os.path.join(RES, "ISS030-E-102170_dc.jpg"))
        if crop:
            # keep the BOTTOM rows (that's where this frame's Earth is)
            # and shift CRPIX2 for the dropped rows
            h, w = crop
            header["CRPIX2"] = float(header["CRPIX2"]) - (img.shape[0] - h)
            img = img[-h:, :w]
            header["IMAGEH"], header["IMAGEW"] = h, w
        shifted = fits.get_shifted_spacecraft_position(header)
        pos = shifted[:3]
        return create_mapping(header, img, pos, fits.get_photo_time(header),
                              altitude=110.0, dtype=dtype)

    def test_azp_mu0_matches_tan_cropped(self):
        """Fast-tier gate on the generic wiring: same AZP(mu=0) == TAN
        equivalence as the full-frame test below, on a cropped frame
        (the per-pixel math is position-independent)."""
        mt = self._mapping_for("TAN", crop=(301, 403))
        ma_ = self._mapping_for("AZP", crop=(301, 403), PV2_1=0.0,
                                PV2_2=0.0)
        lt = np.ma.filled(mt.lats, np.nan)
        la = np.ma.filled(ma_.lats, np.nan)
        assert np.array_equal(np.isnan(lt), np.isnan(la))
        m = ~np.isnan(lt)
        assert m.any()
        assert np.abs(lt[m] - la[m]).max() < 1e-9

    @pytest.mark.slow
    def test_azp_mu0_reproduces_tan_mapping(self):
        """AZP with mu=0 IS the gnomonic projection: the full mapping
        built through the generic chain must agree with the fused TAN
        fast path to float64 roundoff — a non-circular gate on the whole
        generic wiring (directions, intersection, masks, elevation)."""
        mt = self._mapping_for("TAN")
        ma_ = self._mapping_for("AZP", PV2_1=0.0, PV2_2=0.0)
        lt = np.ma.filled(mt.lats, np.nan)
        la = np.ma.filled(ma_.lats, np.nan)
        assert np.array_equal(np.isnan(lt), np.isnan(la))
        m = ~np.isnan(lt)
        assert np.abs(lt[m] - la[m]).max() < 1e-9
        lnt = np.ma.filled(mt.lons, np.nan)
        lna = np.ma.filled(ma_.lons, np.nan)
        dlon = (lnt[m] - lna[m] + 180.0) % 360.0 - 180.0
        assert np.abs(dlon).max() < 1e-9
        et = np.ma.filled(mt.elevation, np.nan)
        ea = np.ma.filled(ma_.elevation, np.nan)
        me = ~np.isnan(et) & ~np.isnan(ea)
        assert me.any()
        assert np.abs(et[me] - ea[me]).max() < 1e-9

    @pytest.mark.slow
    def test_zea_header_georeferences_with_guarantees(self):
        """A genuinely different projection (equal-area ZEA) produces a
        valid mapping: invariants hold, the footprint stays in the same
        region (the projection changes pixel->sky, not the scene), and
        it differs measurably from TAN away from the reference pixel."""
        mz = self._mapping_for("ZEA")
        mz.checkGuarantees()
        lat = np.ma.filled(mz.lats, np.nan)
        assert 40.0 < np.nanmin(lat) and np.nanmax(lat) < 70.0
        mt = self._mapping_for("TAN")
        lt = np.ma.filled(mt.lats, np.nan)
        both = ~np.isnan(lat) & ~np.isnan(lt)
        assert np.abs(lat[both] - lt[both]).max() > 0.01

    @pytest.mark.parametrize("code", ["ZEA", "HPX", "QSC"])
    def test_generic_projection_f32_floor(self, code):
        """The f32 generic chain stays within its documented floor vs the
        f64 oracle (max ~1.6e-3 deg full-frame at step 8; gate 0.01 with
        headroom) with IDENTICAL masks. This is the bound chip_smoke.py's
        generic phase and bench.py's generic_parity_deg gate on the GPU —
        a device-only hazard (a TF32 default matmul on the direction path)
        would land orders of magnitude above it."""
        import jax
        import jax.numpy as jnp

        from auromat_tpu.coordinates.wcs import make_wcs
        from auromat_tpu.ops.georef import georeference_points_generic

        header = dict(fits.read_header(
            os.path.join(RES, "ISS030-E-102170_dc.wcs")))
        pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
        t = fits.get_shifted_photo_time(header)
        p = GeorefParams.from_wcs(TanWcs(header), pos, t, 110.0)
        # the zenithal header's explicit LONPOLE=180 must be dropped for
        # theta0=0 families (HPX/QSC) so their default applies
        h2 = {k: v for k, v in header.items()
              if k.upper() not in ("LONPOLE", "LATPOLE")}
        h2["CTYPE1"] = f"RA---{code}"
        h2["CTYPE2"] = f"DEC--{code}"
        wcs2 = make_wcs(h2)
        xs = np.arange(0, p.width, 16, dtype=np.float64)
        ys = np.arange(0, p.height, 16, dtype=np.float64)
        px, py = np.meshgrid(xs, ys)
        la64, lo64 = (np.asarray(a) for a in georeference_points_generic(
            wcs2, p, px, py, jnp.float64))
        la32, lo32 = (np.asarray(a, dtype=np.float64)
                      for a in georeference_points_generic(
                          wcs2, p, px.astype(np.float32),
                          py.astype(np.float32), jnp.float32))
        assert np.array_equal(np.isnan(la64), np.isnan(la32))
        both = ~np.isnan(la64)
        assert both.sum() > 10_000
        dla = np.abs(la32[both] - la64[both])
        dlo = np.abs(lo32[both] - lo64[both])
        dlo = np.minimum(dlo, 360.0 - dlo)
        assert max(dla.max(), dlo.max()) < 1e-2
        assert np.median(dla) < 1e-4

    def test_df64_requires_zenithal(self):
        """The df64 chain covers the TAN/SIN/ZEA/ARC/STG radial laws; a
        general-zenithal AZP(mu=2) header must be refused with an
        actionable error (MOL etc. never get here — the zenithal header's
        LONPOLE=180 is already invalid for equator-fiducial families)."""
        with pytest.raises(NotImplementedError, match="df64"):
            self._mapping_for("AZP", dtype="df64", PV2_1=2.0, PV2_2=0.0)

    @pytest.mark.parametrize("code", ["SIN", "ZEA", "ARC", "STG"])
    def test_df64_zenithal_matches_f64(self, code):
        """df64 directions for the non-TAN zenithal family (VERDICT r4
        item 2): the trig-free radial-law forms in ops.georef.
        _df_zenithal_dirs agree with the f64 generic chain to f64-grade
        accuracy (<1e-8 deg; the TAN df64 chain measures ~1e-10 on-chip)
        with identical miss masks."""
        import jax.numpy as jnp

        from auromat_tpu.coordinates.wcs import make_wcs
        from auromat_tpu.ops.georef import (georeference_points_df64_full,
                                            georeference_points_generic)

        header = dict(fits.read_header(
            os.path.join(RES, "ISS030-E-102170_dc.wcs")))
        pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
        t = fits.get_shifted_photo_time(header)
        p = GeorefParams.from_wcs(TanWcs(header), pos, t, 110.0)
        h2 = dict(header)
        h2["CTYPE1"] = f"RA---{code}"
        h2["CTYPE2"] = f"DEC--{code}"
        wcs2 = make_wcs(h2)
        xs = np.arange(0, p.width, 16, dtype=np.float64)
        ys = np.arange(0, p.height, 16, dtype=np.float64)
        px, py = np.meshgrid(xs, ys)
        la64, lo64, e64 = (np.asarray(a) for a in
                           georeference_points_generic(
                               wcs2, p, px, py, jnp.float64, True))
        d = georeference_points_df64_full(p, px.astype(np.float32),
                                          py.astype(np.float32),
                                          projection=code)
        assert np.array_equal(np.isnan(la64), np.isnan(d["lat"]))
        m = ~np.isnan(la64)
        assert m.sum() > 10_000
        dlo = np.abs(d["lon"][m] - lo64[m])
        dlo = np.minimum(dlo, 360.0 - dlo)
        assert np.abs(d["lat"][m] - la64[m]).max() < 1e-8
        assert dlo.max() < 1e-8
        assert np.abs(d["elevation"][m] - e64[m]).max() < 1e-8

    def test_create_mapping_df64_zenithal_e2e(self):
        """create_mapping(dtype='df64') on a non-TAN zenithal header
        produces a valid mapping agreeing with the f64 generic route."""
        mdf = self._mapping_for("ZEA", dtype="df64", crop=(301, 403))
        m64 = self._mapping_for("ZEA", dtype=np.float64, crop=(301, 403))
        mdf.checkGuarantees()
        a = np.ma.filled(mdf.lats, np.nan)
        b = np.ma.filled(m64.lats, np.nan)
        both = ~np.isnan(a) & ~np.isnan(b)
        assert both.sum() > 1000
        assert np.abs(a[both] - b[both]).max() < 1e-8

    def test_non_equatorial_header_refused(self):
        """The georef chain reads directions as GCRS~ICRS: a galactic
        header must be refused, not silently mis-framed."""
        from auromat_tpu.io.image import load_image
        from auromat_tpu.mapping.astrometry import create_mapping

        header = dict(fits.read_header(
            os.path.join(RES, "ISS030-E-102170_dc.wcs")))
        header["CTYPE1"], header["CTYPE2"] = "GLON-ZEA", "GLAT-ZEA"
        img = load_image(os.path.join(RES, "ISS030-E-102170_dc.jpg"))
        pos = fits.get_shifted_spacecraft_position(header)[:3]
        with pytest.raises(ValueError, match="equatorial"):
            create_mapping(header, img, pos, fits.get_photo_time(header),
                           altitude=110.0)
