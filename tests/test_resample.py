"""Resample tests mirroring the reference's synthetic-mapping strategy
(auromat/test/resample_test.py): procedurally generated coordinate grids with
a circular NaN hole, plus discontinuity-shifted and pole-rotated variants;
assert plate-carree regularity of the results."""

import datetime
import os

import numpy as np
import numpy.ma as ma
import pytest

from auromat_tpu.coordinates.transform import rotate_pole, wrap_longitude
from auromat_tpu.mapping.mapping import Mapping, check_plate_carree
from auromat_tpu.mapping.spacecraft import get_mapping
from auromat_tpu.resample import plate_carree_resolution, resample, resample_mlat_mlt

RES = os.path.join(os.path.dirname(__file__), "resources")


def _test_coords(offset, n=10):
    """Coordinate grid where only a circular disk is defined (the reference's
    fixture shape, auromat/test/resample_test.py:21-36)."""
    sp = np.linspace(offset, offset + 10, n)
    step = sp[1] - sp[0]
    coord = np.tile(sp, n).reshape(n, n).astype(np.float64)
    r = n * 0.4
    yy, xx = np.mgrid[:n, :n]
    disk = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 <= r**2
    coord[~disk] = np.nan
    center = coord[:-1, :-1] + step / 2
    return coord, center


def synthetic(offset_lat=70, offset_lon=160, shift_lon=0.0, pole_rotate=False):
    lats, lats_c = _test_coords(offset_lat)
    lats, lats_c = lats.T, lats_c.T
    lons, lons_c = _test_coords(offset_lon)
    if shift_lon:
        lons = np.asarray(wrap_longitude(lons + shift_lon))
        lons_c = np.asarray(wrap_longitude(lons_c + shift_lon))
    if pole_rotate:
        la, lo = rotate_pole(np.deg2rad(lats.ravel()), np.deg2rad(lons.ravel()), 0.0,
                             angle_deg=90.0, axis=(0, 1, 0))
        lats = np.rad2deg(np.asarray(la)).reshape(lats.shape)
        lons = np.rad2deg(np.asarray(lo)).reshape(lons.shape)
        la, lo = rotate_pole(np.deg2rad(lats_c.ravel()), np.deg2rad(lons_c.ravel()), 0.0,
                             angle_deg=90.0, axis=(0, 1, 0))
        lats_c = np.rad2deg(np.asarray(la)).reshape(lats_c.shape)
        lons_c = np.rad2deg(np.asarray(lo)).reshape(lons_c.shape)
    n = lats.shape[0] - 1
    rng = np.random.default_rng(3)
    img = (rng.random((n, n, 3)) * 255).astype(np.uint8)
    elevation = np.zeros((n, n))
    return Mapping(
        lats, lons, lats_c, lons_c, elevation, 110.0, img,
        np.array([0.0, 0.0, 0.0]), datetime.datetime(2012, 1, 25, 9, 26, 55),
        None,
    )


class TestResample:
    def test_mean_plate_carree(self):
        m = resample(synthetic(), px_per_deg=1, method="mean")
        m.checkPlateCarree()
        m.checkGuarantees()

    def test_mean_discontinuity(self):
        mapping = synthetic(shift_lon=15.0)
        assert mapping.containsDiscontinuity
        m = resample(mapping, px_per_deg=1, method="mean")
        # result lons cross the discontinuity; regular after unwrapping,
        # which checkPlateCarree performs internally
        m.checkPlateCarree()

    def test_mean_pole(self):
        mapping = synthetic(offset_lat=-5, offset_lon=-5, pole_rotate=True)
        assert mapping.containsPole
        m = resample(mapping, px_per_deg=1, method="mean")
        # pole-rotated grids are not plate carree in geo coords, but the
        # data must exist and mask invariants hold
        m.checkGuarantees()
        assert (~m.center_mask).sum() > 10

    def test_nearest(self):
        m = resample(synthetic(), px_per_deg=1, method="nearest")
        m.checkPlateCarree()
        m.checkGuarantees()

    @pytest.mark.slow
    def test_nearest_device_matches_scipy(self):
        """The device jump-flood nearest path (ops.regrid.bin_nearest) against
        the host scipy KD-tree path: identical masks, near-identical cells
        (JFA/seeding picks a different-but-nearby sample only for a tiny
        fraction of cells — see bin_nearest docstring)."""
        mapping = synthetic()
        m_ref = resample(mapping, px_per_deg=2, method="nearest")
        m_dev = resample(mapping, px_per_deg=2, method="nearest_device")
        m_dev.checkPlateCarree()
        m_dev.checkGuarantees()
        a = np.asarray(m_dev.img_unmasked, dtype=np.float64)
        b = np.asarray(m_ref.img_unmasked, dtype=np.float64)
        assert a.shape == b.shape
        # outline masking must agree exactly (same host mask path)
        na, nb = np.isnan(a).all(axis=-1), np.isnan(b).all(axis=-1)
        assert np.array_equal(na, nb)
        inside = ~na
        assert inside.sum() > 50
        same = np.all(a[inside] == b[inside], axis=-1)
        assert same.mean() > 0.95, same.mean()

    def test_nearest_routes_to_device_on_gpu(self, monkeypatch):
        """resample(method='nearest') must use the device jump-flood path
        when the default backend is a GPU (the production method should
        not silently fall back to a host KD-tree), and 'nearest_host' must
        force scipy regardless of backend."""
        import jax

        import auromat_tpu.ops.regrid as regrid

        mapping = synthetic()
        calls = []
        real = regrid.bin_nearest
        monkeypatch.setattr(regrid, "bin_nearest",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        m_auto = resample(mapping, px_per_deg=2, method="nearest")
        assert calls, "nearest did not route to the device path on a GPU"
        m_dev = resample(mapping, px_per_deg=2, method="nearest_device")
        assert np.array_equal(
            np.asarray(m_auto.img_unmasked, np.float64),
            np.asarray(m_dev.img_unmasked, np.float64), equal_nan=True)
        # the escape hatch keeps scipy available on any backend
        calls.clear()
        m_host = resample(mapping, px_per_deg=2, method="nearest_host")
        assert not calls
        assert m_host.img_unmasked.shape == m_dev.img_unmasked.shape

    @pytest.mark.slow
    def test_linear_device_matches_scipy_shape(self):
        """The device linear path (Newton mesh inversion + bilinear sampling,
        ops.regrid.interp_linear_structured) against the host scipy
        Delaunay path: plate-carree regular, invariants hold, and its
        valid-cell set is (up to the documented <=1-cell NaN band at the
        footprint edge) the scipy set. Value-level parity is gated in
        test_regrid.TestInterpLinearStructured on affine/smooth fields —
        on random imagery the quad-bilinear and triangle-linear weightings
        legitimately differ within a cell."""
        mapping = synthetic()
        m_ref = resample(mapping, px_per_deg=2, method="linear")
        m_dev = resample(mapping, px_per_deg=2, method="linear_device")
        m_dev.checkPlateCarree()
        m_dev.checkGuarantees()
        a = np.asarray(m_dev.img_unmasked, dtype=np.float64)
        b = np.asarray(m_ref.img_unmasked, dtype=np.float64)
        assert a.shape == b.shape
        na, nb = np.isnan(a).all(axis=-1), np.isnan(b).all(axis=-1)
        # device-valid cells are scipy-valid (no fabricated cells)...
        assert not (nb & ~na).any()
        # ...and cover nearly all of them (edge band only)
        both = (~na).sum()
        assert both > 0.9 * (~nb).sum(), (both, (~nb).sum())
        # interpolated values stay inside the sample range
        assert np.nanmin(a) >= 0 and np.nanmax(a) <= 255

    @pytest.mark.slow
    def test_cubic_device(self):
        """Device cubic (mesh inversion + Catmull-Rom): invariants hold and
        no cells are fabricated outside the scipy-cubic hull; the full
        4x4-stencil requirement costs a wider edge band than linear."""
        mapping = synthetic()
        m_ref = resample(mapping, px_per_deg=2, method="cubic")
        m_dev = resample(mapping, px_per_deg=2, method="cubic_device")
        m_dev.checkPlateCarree()
        m_dev.checkGuarantees()
        a = np.asarray(m_dev.img_unmasked, dtype=np.float64)
        b = np.asarray(m_ref.img_unmasked, dtype=np.float64)
        na, nb = np.isnan(a).all(axis=-1), np.isnan(b).all(axis=-1)
        assert not (nb & ~na).any()
        assert (~na).sum() > 50

    def test_cubic_overshoot_clipped_not_wrapped(self):
        """Cubic interpolation overshoots on sharp edges; the uint8 cast
        must CLAMP (272 -> 255), not wrap (272 -> 16). Gate: the uint8
        result equals the clipped+rounded float-image result."""
        m_int = synthetic()
        img = np.zeros_like(np.asarray(m_int.img_unmasked))
        img[:, img.shape[1] // 2 :] = 255  # hard dark/bright edge
        mk = lambda im: Mapping(
            np.asarray(m_int.lats), np.asarray(m_int.lons),
            np.asarray(m_int.latsCenter), np.asarray(m_int.lonsCenter),
            np.asarray(m_int.elevation), m_int.altitude, im,
            np.array([0.0, 0.0, 0.0]), m_int.photoTime, None)
        r_int = resample(mk(img.astype(np.uint8)), px_per_deg=2,
                         method="cubic_device")
        r_flt = resample(mk(img.astype(np.float64)), px_per_deg=2,
                         method="cubic_device")
        a = np.asarray(r_int.img_unmasked, dtype=np.float64)
        b = np.asarray(r_flt.img_unmasked, dtype=np.float64)
        ok = ~np.isnan(b)
        assert np.nanmax(b) > 255.5, "fixture no longer overshoots"
        assert np.array_equal(a[ok], np.clip(np.round(b[ok]), 0, 255))

    def test_mlat_mlt_roundtrip_regular(self):
        mapping = synthetic()
        res = resample_mlat_mlt(mapping, arcsec_per_px=3600 * 0.5, method="nearest")
        assert not res.isPlateCarree
        mlat, mlt = res.mLatMlt
        from auromat_tpu.coordinates.transform import mlt_to_sm_lon

        smlon = mlt_to_sm_lon(np.asarray(mlt.data))
        check_plate_carree(np.asarray(mlat.data), np.asarray(smlon))

    def test_arcsec_resolution(self):
        m0 = synthetic()
        lat_ppd, lon_ppd = plate_carree_resolution(m0.boundingBox, 3600.0)
        assert lat_ppd == pytest.approx(1.0)
        # at lat ~75, one degree of longitude is ~cos(75) short
        assert 0.2 < lon_ppd < 0.5
        m = resample(m0, arcsec_per_px=3600.0, method="mean")
        m.checkPlateCarree()

    @pytest.mark.slow
    def test_real_frame_resample(self):
        mapping = get_mapping(
            os.path.join(RES, "ISS030-E-102170_dc.jpg"),
            os.path.join(RES, "ISS030-E-102170_dc.wcs"),
            fast_center=True,
        )
        m = resample(mapping, px_per_deg=15, method="mean")
        m.checkPlateCarree()
        m.checkGuarantees()
        # bbox approx preserved (reference resample_test.py:91-100)
        for a, b in zip(
            (m.boundingBox.latNorth, m.boundingBox.latSouth,
             m.boundingBox.lonWest, m.boundingBox.lonEast),
            (mapping.boundingBox.latNorth, mapping.boundingBox.latSouth,
             mapping.boundingBox.lonWest, mapping.boundingBox.lonEast),
        ):
            assert a == pytest.approx(b, abs=0.5)  # horizon cells thin out under mean binning
        # image content present
        assert (~m.center_mask).mean() > 0.3
        # resampling again at lower res still plate carree
        m2 = resample(m, arcsec_per_px=3600 / 10, method="nearest")
        m2.checkPlateCarree()


def test_sm_to_geo_preserves_mask():
    """convert_sm_mapping_to_geo must carry the SM mapping's masks over
    (resampled SM grids are regular with separate masks; deriving masks
    from converted-data NaNs would lose them)."""
    from auromat_tpu.mapping.mapping import convert_sm_mapping_to_geo

    mapping = synthetic()
    res = resample_mlat_mlt(mapping, arcsec_per_px=3600 * 0.5, method="mean")
    # the resampled mag mapping must have SOME masked cells and the geo
    # conversion must keep exactly that footprint
    assert res.center_mask.any() and not res.center_mask.all()
    assert res.corner_mask.any()
    res.checkGuarantees()


def test_resample_without_elevation():
    """CDF/netCDF files without a zenith_angle variable load as mappings
    with elevation=None; resampling them must work (previously crashed on
    None.filled) and keep elevation None on the result."""
    from datetime import datetime

    import numpy.ma as ma

    from auromat_tpu.mapping.mapping import check_guarantees

    h, w = 24, 32
    lat = np.linspace(45, 50, h + 1)[:, None] + np.zeros(w + 1)
    lon = np.linspace(-5, 5, w + 1)[None, :] + np.zeros((h + 1, 1))
    latc = (lat[:-1, :-1] + lat[1:, 1:]) / 2
    lonc = (lon[:-1, :-1] + lon[1:, 1:]) / 2
    img = np.random.default_rng(0).integers(0, 256, (h, w)).astype(np.uint8)
    m = Mapping(ma.masked_invalid(lat), ma.masked_invalid(lon),
                ma.masked_invalid(latc), ma.masked_invalid(lonc),
                None, 110.0, ma.masked_array(img),
                np.array([0.0, 0.0, 7000e3]), datetime(2012, 1, 25, 9, 27), "t")
    r = resample(m, px_per_deg=4)
    assert r.elevation is None
    check_guarantees(r)  # must tolerate elevation=None too


def test_resample_provider_wraps_batched():
    """ResampleProvider must wrap getSequenceBatched as well: batched
    consumers dispatch on hasattr and would otherwise silently receive
    unresampled mappings."""
    from auromat_tpu.resample import ResampleProvider

    class P:
        def get(self):
            return "m"

        def getById(self, i):
            return "m"

        def getSequence(self):
            return iter(["m"])

        def getSequenceBatched(self):
            return iter(["m", "m"])

    p = ResampleProvider(P())
    # the wrapped method must be a new function, not the original bound
    # method of the copied provider
    orig = P()
    assert p.getSequenceBatched != orig.getSequenceBatched
    assert callable(p.getSequenceBatched)
    # MaskByElevationProvider gets the same treatment
    from auromat_tpu.mapping.mapping import MaskByElevationProvider

    masked = []

    class M:
        def maskedByElevation(self, *a, **k):
            masked.append(self)
            return self

    class P2(P):
        def getSequence(self):
            return iter([M()])

        def getSequenceBatched(self):
            return iter([M(), M()])

    p2 = MaskByElevationProvider(P2(), 10)
    list(p2.getSequenceBatched())
    assert len(masked) == 2  # both batched mappings were masked


class TestMosaic:
    """Device mosaic compositing of overlapping collections
    (resample.mosaic + ops.regrid.bin_take_best)."""

    @staticmethod
    def _station(offset_lat, offset_lon, elev_value, img_value):
        lats, lats_c = _test_coords(offset_lat)
        lats, lats_c = lats.T, lats_c.T
        lons, lons_c = _test_coords(offset_lon)
        n = lats.shape[0] - 1
        img = np.full((n, n, 3), img_value, np.uint8)
        elevation = np.full((n, n), float(elev_value))
        return Mapping(
            lats, lons, lats_c, lons_c, elevation, 110.0, img,
            np.array([0.0, 0.0, 0.0]),
            datetime.datetime(2012, 1, 25, 9, 26, 55), f"st{img_value}",
        )

    def test_overlap_takes_highest_elevation(self):
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        # two overlapping disks; station B views everything at higher
        # elevation, so every overlap cell must be B's
        a = self._station(70, 160, 20.0, 10)
        b = self._station(74, 164, 60.0, 200)
        coll = MappingCollection([a, b], "pair", mayOverlap=True)
        m = mosaic(coll, px_per_deg=1)
        m.checkPlateCarree()
        m.checkGuarantees()
        img = np.asarray(m.img.filled(0))
        el = np.asarray(m.elevation.filled(np.nan))
        # cells carrying B's elevation carry B's pixels, and both stations
        # survive somewhere
        assert ((img[..., 0] == 200) == (el == 60.0)).all()
        assert (img[..., 0] == 200).any() and (img[..., 0] == 10).any()
        # overlap region exists and is entirely B's
        only_a = self._station(70, 160, 20.0, 10)
        ra = np.asarray(
            mosaic(MappingCollection([only_a], "a"), px_per_deg=1)
            .img.filled(0))
        assert (ra[..., 0] == 10).sum() > (img[..., 0] == 10).sum()

    def test_identifier_and_errors(self):
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._station(70, 160, 20.0, 10)
        m = mosaic(MappingCollection([a], "THEMIS.X"), px_per_deg=1)
        assert m.identifier == "THEMIS.X.mosaic"
        assert np.isnan(m.cameraPosGCRS).all()
        with pytest.raises(ValueError):
            mosaic(MappingCollection([], "e"))
        b = self._station(70, 160, 20.0, 10)
        b._altitude = 220.0
        with pytest.raises(ValueError):
            mosaic(MappingCollection([a, b], "alt"))

    @staticmethod
    def _pole_station(offset_lat, offset_lon, elev_value, img_value):
        """A pole-containing station: an equator-region disk rotated onto
        the pole (same construction as synthetic(pole_rotate=True)), with
        controllable constant elevation/brightness for take-best gates."""
        lats, lats_c = _test_coords(offset_lat)
        lats, lats_c = lats.T, lats_c.T
        lons, lons_c = _test_coords(offset_lon)

        def rot(la, lo):
            la2, lo2 = rotate_pole(np.deg2rad(la.ravel()),
                                   np.deg2rad(lo.ravel()), 0.0,
                                   angle_deg=90.0, axis=(0, 1, 0))
            return (np.rad2deg(np.asarray(la2)).reshape(la.shape),
                    np.rad2deg(np.asarray(lo2)).reshape(lo.shape))

        lats, lons = rot(lats, lons)
        lats_c, lons_c = rot(lats_c, lons_c)
        n = lats.shape[0] - 1
        img = np.full((n, n, 3), img_value, np.uint8)
        elevation = np.full((n, n), float(elev_value))
        return Mapping(
            lats, lons, lats_c, lons_c, elevation, 110.0, img,
            np.array([0.0, 0.0, 0.0]),
            datetime.datetime(2012, 1, 25, 9, 26, 55), f"pst{img_value}",
        )

    def test_pole_mosaic_takes_highest_elevation(self):
        """Pole-containing collections mosaic through the rotate-pole
        frame (VERDICT r4 item 5): take-best semantics hold, the result
        footprint still contains the pole, and the grid construction is
        bit-identical to the per-frame pole resample path."""
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._pole_station(-5, -5, 20.0, 10)
        b = self._pole_station(-2, -3, 60.0, 200)
        # a mixed collection: one pole-containing station plus an
        # overlapping near-pole one — ALL stations must rotate together
        assert a.containsPole and not b.containsPole
        m = mosaic(MappingCollection([a, b], "polar", mayOverlap=True),
                   px_per_deg=1)
        m.checkGuarantees()
        assert m.containsPole
        img = np.asarray(m.img.filled(0))
        el = np.asarray(m.elevation.filled(np.nan))
        # overlap cells must be B's (higher elevation); both survive
        assert ((img[..., 0] == 200) == (el == 60.0)).all()
        assert (img[..., 0] == 200).any() and (img[..., 0] == 10).any()

    def test_pole_mosaic_grid_matches_per_frame_resample(self):
        """A single-mapping pole mosaic lands on the SAME rotated-frame
        grid as resample(mapping) (shared outline-extent + fixed_grid
        machinery) with identical cell occupancy (a cell has a mean iff
        it has a best sample)."""
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._pole_station(-5, -5, 20.0, 10)
        m = mosaic(MappingCollection([a], "single"), px_per_deg=1)
        r = resample(a, px_per_deg=1, method="mean")
        la_m = np.asarray(m.lats.filled(np.nan))
        la_r = np.asarray(r.lats.filled(np.nan))
        assert la_m.shape == la_r.shape
        np.testing.assert_allclose(la_m, la_r, atol=1e-12)
        lo_m = np.asarray(m.lons.filled(np.nan))
        lo_r = np.asarray(r.lons.filled(np.nan))
        dlo = np.abs(lo_m - lo_r)
        assert np.nanmax(np.minimum(dlo, 360.0 - dlo)) < 1e-12
        assert np.array_equal(np.isnan(np.asarray(m.elevation.filled(np.nan))),
                              np.isnan(np.asarray(r.elevation.filled(np.nan))))

    @staticmethod
    def _rotated_frame_station(rla_off, rlo_off, elev_value, img_value):
        """A station whose footprint is a disk in the MOSAIC's rotated
        frame (+90 deg about the x axis at the emission altitude):
        geographic coords are the inverse rotation of the rotated-frame
        disk, so after mosaic() rotates the collection the footprint sits
        exactly at (rla_off+5, rlo_off+5) in the rotated frame."""
        lats, lats_c = _test_coords(rla_off)
        lats, lats_c = lats.T, lats_c.T
        lons, lons_c = _test_coords(rlo_off)
        lons = np.asarray(wrap_longitude(lons))
        lons_c = np.asarray(wrap_longitude(lons_c))

        def inv(la, lo):
            la2, lo2 = rotate_pole(np.deg2rad(la.ravel()),
                                   np.deg2rad(lo.ravel()), 110.0,
                                   angle_deg=-90.0, axis=(1, 0, 0))
            return (np.rad2deg(np.asarray(la2)).reshape(la.shape),
                    np.rad2deg(np.asarray(lo2)).reshape(lo.shape))

        lats, lons = inv(lats, lons)
        lats_c, lons_c = inv(lats_c, lons_c)
        n = lats.shape[0] - 1
        img = np.full((n, n, 3), img_value, np.uint8)
        elevation = np.full((n, n), float(elev_value))
        return Mapping(
            lats, lons, lats_c, lons_c, elevation, 110.0, img,
            np.array([0.0, 0.0, 0.0]),
            datetime.datetime(2012, 1, 25, 9, 26, 55), f"rfs{img_value}",
        )

    def test_pole_mosaic_rotated_antimeridian_member(self):
        """A member that does not itself contain a pole can straddle the
        ROTATED frame's antimeridian; vertex min/max extent would grid
        (nearly) the whole circle and clip the seam sliver — the
        wrap-aware extent composes in the +180-shifted rotated frame and
        keeps the grid compact with every member present."""
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._pole_station(-5, -5, 20.0, 10)
        s = self._rotated_frame_station(-10, 176.0, 60.0, 77)
        assert a.containsPole and not s.containsPole
        # the straddle is the point of the fixture: the member's rotated
        # outline must cross +-180
        from auromat_tpu.resample import _min_lon_interval_deg, _rotate_pole_deg
        _, olo = _rotate_pole_deg(s.outline[:, 0], s.outline[:, 1], 90.0,
                                  110.0)
        w, e = _min_lon_interval_deg(olo)
        assert w > 0 > e, (w, e)
        m = mosaic(MappingCollection([a, s], "seam", mayOverlap=True),
                   px_per_deg=1)
        m.checkGuarantees()
        # the pole-containing member survives (its unrotated cells reach
        # the pole; .containsPole itself keys off the single-contour
        # outline, which a DISCONNECTED two-blob footprint defeats)
        la = np.asarray(m.lats.filled(np.nan))
        assert min(abs(np.nanmin(la)), abs(np.nanmax(la))) >= 0 and \
            max(abs(np.nanmin(la)), abs(np.nanmax(la))) > 89.0
        img = np.asarray(m.img.filled(0))
        assert (img[..., 0] == 10).any() and (img[..., 0] == 77).any()
        # compact rotated-frame grid: the two footprints span ~100 deg of
        # rotated longitude, not the whole circle the complement interval
        # would produce
        assert img.shape[1] < 300

    def test_pole_mosaic_refuses_rotated_pole_member(self):
        """A member whose footprint surrounds the ROTATED frame's pole has
        no covering lon interval in that frame — mosaic() must refuse
        loudly instead of silently dropping its samples."""
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._pole_station(-5, -5, 20.0, 10)
        # geographic preimage of the rotated-frame pole lies on the
        # equator at lon +-90; probe which sign this rotation convention
        # uses and centre a disk there
        for lon0 in (90.0, -90.0):
            la2, _ = rotate_pole(np.deg2rad(np.array([0.0])),
                                 np.deg2rad(np.array([lon0])), 110.0,
                                 angle_deg=90.0, axis=(1, 0, 0))
            if abs(float(np.rad2deg(np.asarray(la2))[0])) > 89.0:
                break
        c = self._station(-5, lon0 - 5, 30.0, 99)
        assert not c.containsPole
        with pytest.raises(ValueError, match="rotated-frame pole"):
            mosaic(MappingCollection([a, c], "bad", mayOverlap=True),
                   px_per_deg=1)

    def test_discontinuity(self):
        from auromat_tpu.mapping.mapping import MappingCollection
        from auromat_tpu.resample import mosaic

        a = self._station(70, 160, 20.0, 10)
        lats = np.asarray(a.lats.filled(np.nan))
        lons = np.asarray(wrap_longitude(
            np.asarray(a.lons.filled(np.nan)) + 15.0))
        lats_c = np.asarray(a.latsCenter.filled(np.nan))
        lons_c = np.asarray(wrap_longitude(
            np.asarray(a.lonsCenter.filled(np.nan)) + 15.0))
        sh = Mapping(lats, lons, lats_c, lons_c,
                     np.asarray(a.elevation.filled(np.nan)), 110.0,
                     np.asarray(a.img.filled(0)),
                     np.array([0.0, 0.0, 0.0]),
                     datetime.datetime(2012, 1, 25, 9, 26, 55), "sh")
        assert sh.containsDiscontinuity
        m = mosaic(MappingCollection([sh], "d"), px_per_deg=1)
        m.checkPlateCarree()
        assert (np.asarray(m.img.filled(0)) > 0).any()
