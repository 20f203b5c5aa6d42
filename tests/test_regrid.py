"""Regrid op tests: parity with a numpy histogram2d oracle + grid alignment.

The oracle replicates the reference's 'mean' rebinning semantics
(auromat/resample.py:328-351): one histogram2d pass over unmasked pixel
centres with weight list [count, ch0, ch1, ...], divide, NaN where empty,
flip to decreasing latitudes.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from auromat_tpu.ops.regrid import (
    GridSpec,
    bin_mean,
    bin_partial,
    finalize_mean,
    fixed_grid,
)


def numpy_mean_rebin(grid: GridSpec, lats, lons, data):
    lats, lons = np.ravel(lats), np.ravel(lons)
    flat = data.reshape(-1, data.shape[-1])
    ok = ~np.isnan(lats)
    lats, lons, flat = lats[ok], lons[ok], flat[ok]
    lat_edges = np.sort(grid.lat_corners)
    lon_edges = grid.lon_corners
    count, _, _ = np.histogram2d(lons, lats, bins=[lon_edges, lat_edges])
    out = []
    for c in range(flat.shape[1]):
        s, _, _ = np.histogram2d(lons, lats, bins=[lon_edges, lat_edges], weights=flat[:, c])
        with np.errstate(invalid="ignore"):
            m = np.where(count > 0, s / count, np.nan)
        out.append(np.flipud(m.T))
    return np.flipud(count.T), np.dstack(out)


def synthetic_mapping(n=80, lat0=60.0, lon0=-100.0):
    rng = np.random.default_rng(7)
    lats = lat0 + np.cumsum(rng.random((n, n)) * 0.01, axis=0)
    lons = lon0 + np.cumsum(rng.random((n, n)) * 0.01, axis=1)
    # circular masked hole
    yy, xx = np.mgrid[:n, :n]
    hole = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (n / 6) ** 2
    lats[hole] = np.nan
    lons[hole] = np.nan
    data = rng.random((n, n, 4)) * 255
    return lats, lons, data


class TestFixedGrid:
    def test_global_alignment(self):
        """Grids from different bboxes at the same resolution share cells."""
        g1 = fixed_grid(25, 50.1, 60.2, -110.3, -95.4)
        g2 = fixed_grid(25, 55.7, 65.9, -101.2, -90.8)
        # centre coordinates are on the same global lattice
        k_lat = (g1.lat0 - g2.lat0) / g1.lat_step
        k_lon = (g1.lon0 - g2.lon0) / g1.lon_step
        assert abs(k_lat - round(k_lat)) < 1e-9
        assert abs(k_lon - round(k_lon)) < 1e-9
        assert g1.lat_step == g2.lat_step

    def test_covers_bbox(self):
        g = fixed_grid((25, 20), 50.0, 60.0, -110.0, -95.0)
        assert g.lat_corners[0] >= 60.0 - g.lat_step
        assert np.all(np.diff(g.lat_centers) < 0)
        assert np.all(np.diff(g.lon_centers) > 0)

    def test_anisotropic(self):
        g = fixed_grid((25, 10), 50.0, 60.0, -110.0, -95.0)
        assert abs(g.lat_step - 1 / 25) < 1e-9
        assert abs(g.lon_step - 1 / 10) < 1e-9


class TestBinMean:
    @pytest.mark.parametrize("method", ["segment", "scatter", "sorted"])
    def test_matches_numpy_oracle(self, method):
        lats, lons, data = synthetic_mapping()
        g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats), np.nanmin(lons), np.nanmax(lons))
        count, means = bin_mean(g, lats, lons, data, method)
        ref_count, ref_means = numpy_mean_rebin(g, lats, lons, data)
        assert_allclose(np.asarray(count), ref_count)
        assert np.array_equal(np.isnan(np.asarray(means)), np.isnan(ref_means))
        m = ~np.isnan(ref_means)
        assert_allclose(np.asarray(means)[m], ref_means[m], atol=1e-9)

    def test_empty_cells_nan(self):
        lats = np.array([50.0, 50.0])
        lons = np.array([-100.0, -100.0])
        data = np.array([[1.0], [3.0]])
        g = fixed_grid(1, 45.0, 55.0, -105.0, -95.0)
        count, means = bin_mean(g, lats, lons, data)
        count, means = np.asarray(count), np.asarray(means)
        assert count.sum() == 2
        filled = count > 0
        assert means[filled][0, 0] == 2.0
        assert np.isnan(means[~filled]).all()

    def test_out_of_range_dropped(self):
        lats = np.array([50.0, 89.0, np.nan])
        lons = np.array([-100.0, 10.0, -100.0])
        data = np.ones((3, 1))
        g = fixed_grid(1, 45.0, 55.0, -105.0, -95.0)
        count, _ = bin_mean(g, lats, lons, data)
        assert np.asarray(count).sum() == 1

    def test_partial_plus_finalize_equals_mean(self):
        lats, lons, data = synthetic_mapping(40)
        g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats), np.nanmin(lons), np.nanmax(lons))
        count, means = bin_mean(g, lats, lons, data)
        # split samples into two "shards", accumulate partials, reduce, divide
        half = lats.shape[0] // 2
        c1, s1 = bin_partial(g, lats[:half], lons[:half], data[:half])
        c2, s2 = bin_partial(g, lats[half:], lons[half:], data[half:])
        merged = finalize_mean(np.asarray(c1) + np.asarray(c2), np.asarray(s1) + np.asarray(s2))
        mm = ~np.isnan(np.asarray(means))
        assert np.array_equal(np.isnan(np.asarray(merged)), ~mm)
        assert_allclose(np.asarray(merged)[mm], np.asarray(means)[mm], atol=1e-9)

    def test_uint8_image_channels(self):
        # image data arrives as float64-cast uint8 (reference resample.py:119)
        lats, lons, data = synthetic_mapping(30)
        data = np.round(data).astype(np.uint8).astype(np.float64)
        g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats), np.nanmin(lons), np.nanmax(lons))
        count, means = bin_mean(g, lats, lons, data)
        ref_count, ref_means = numpy_mean_rebin(g, lats, lons, data)
        m = ~np.isnan(ref_means)
        assert_allclose(np.asarray(means)[m], ref_means[m], atol=1e-9)


class TestFullCoverageRegression:
    def test_all_valid_samples_high_bins(self):
        """Regression: with NO invalid samples (no dump-slot entries in the
        sorted keys), bins above the maximum occupied bin query past the end
        of the key array; the binary search used to return n+1 there, making
        the top occupied bin's count +1 and its sums read out-of-range
        prefix chunks (observed: sums off by a whole ~520k chunk total)."""
        from auromat_tpu.ops.regrid import bin_partial, bin_indices, fixed_grid

        rng = np.random.default_rng(5)
        h, w = 128, 256
        lat = np.clip(52 + 4 * np.linspace(0, 1, h)[:, None]
                      + 0.1 * rng.standard_normal((h, w)), 45.1, 59.9)
        lon = np.clip(-105 + 8 * np.linspace(0, 1, w)[None, :]
                      + 0.1 * rng.standard_normal((h, w)), -109.9, -90.1)
        data = rng.integers(0, 256, (h, w, 4)).astype(np.float32)
        g = fixed_grid(25, 45.0, 60.0, -110.0, -90.0)
        flat, valid = map(np.asarray, bin_indices(g, lat.ravel(), lon.ravel()))
        assert valid.all()  # the failure precondition: zero dump entries
        nb = g.n_lat * g.n_lon
        oracle_c = np.bincount(flat, minlength=nb).astype(np.float64)
        oracle_s = np.zeros((nb, 4))
        np.add.at(oracle_s, flat, data.reshape(-1, 4).astype(np.float64))
        for method in ("sorted", "sorted_packed", "segment"):
            c, s = map(np.asarray, bin_partial(g, lat, lon, data, method))
            assert np.array_equal(c.ravel(), oracle_c), method
            np.testing.assert_allclose(s.reshape(nb, 4), oracle_s, atol=0.5,
                                       err_msg=method)


class TestNanDataSemantics:
    def test_nan_taints_only_its_bin(self):
        """Regression: a NaN data value at valid coordinates must taint ONLY
        its own bin+channel (numpy bincount semantics). The sorted path's
        raw prefix sums would leak the NaN into every bin after it in sort
        order."""
        from auromat_tpu.ops.regrid import bin_mean, fixed_grid

        g = fixed_grid(1, 45.0, 55.0, -105.0, -95.0)
        # three samples in three separate cells; middle one has NaN in ch0
        lats = np.array([46.5, 50.5, 53.5])
        lons = np.array([-103.5, -99.5, -96.5])
        data = np.array([[1.0, 10.0], [np.nan, 20.0], [3.0, 30.0]],
                        dtype=np.float32)
        for method in ("sorted", "sorted_packed", "segment"):
            count, means = map(np.asarray,
                               bin_mean(g, lats, lons, data, method))
            filled = count > 0
            assert filled.sum() == 3
            vals0 = means[..., 0][filled]
            vals1 = means[..., 1][filled]
            # ch0: exactly ONE NaN (the middle sample's bin); ch1: none
            assert np.isnan(vals0).sum() == 1, method
            assert not np.isnan(vals1).any(), method
            assert set(vals0[~np.isnan(vals0)]) == {1.0, 3.0}, method
            assert set(vals1) == {10.0, 20.0, 30.0}, method


def test_sorted_packed_taint_layout():
    """bin_mean doubles the channel count with taint indicators; the
    packed path must pack THAT layout (RGB bits 0..23 + taint bits
    24..27), not misinterpret it through the 4-channel case."""
    rng = np.random.default_rng(8)
    n = 4000
    lats = rng.uniform(50, 60, n)
    lons = rng.uniform(-110, -100, n)
    g = fixed_grid(4, 49.0, 61.0, -111.0, -99.0)
    data = np.round(rng.random((n, 4)) * 255)
    data[:, 3] = rng.uniform(-10, 80, n)  # elevation incl. negatives
    data[rng.random(n) < 0.05, 3] = np.nan  # NaN at VALID coords -> taint
    c_ref, m_ref = bin_mean(g, lats, lons, data, "sorted")
    c_pk, m_pk = bin_mean(g, lats, lons, data, "sorted_packed")
    np.testing.assert_array_equal(np.asarray(c_ref), np.asarray(c_pk))
    a, b = np.asarray(m_ref), np.asarray(m_pk)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=1e-6)


def test_bin_partial_nan_data_zeroed():
    """bin_partial treats NaN data at valid coords as 0 (documented) —
    a raw NaN riding the sorted prefix sums would corrupt every bin after
    it in sort order."""
    lats = np.array([50.1, 50.1, 55.0, 58.0])
    lons = np.array([-105.0, -105.0, -104.0, -103.0])
    g = fixed_grid(1, 49.0, 61.0, -111.0, -99.0)
    data = np.array([[1.0], [np.nan], [2.0], [3.0]])
    count, sums = bin_partial(g, lats, lons, data, "sorted")
    count, sums = np.asarray(count), np.asarray(sums)
    assert np.isfinite(sums).all()
    assert count.sum() == 4
    assert sums.sum() == 6.0  # the NaN sample contributes 0


def test_sorted_packed_grayscale_falls_back():
    """Grayscale + elevation through bin_mean doubles to 4 channels
    [gray, elev, t0, t1] — the packed path must NOT misread that as
    [R, G, B, elev] (which truncated elevation to int). It falls back
    to the general sorted path and must match it exactly."""
    rng = np.random.default_rng(9)
    n = 4000
    lats = rng.uniform(50, 60, n)
    lons = rng.uniform(-110, -100, n)
    g = fixed_grid(4, 49.0, 61.0, -111.0, -99.0)
    data = np.stack([np.round(rng.random(n) * 255),
                     rng.uniform(-10, 80, n)], axis=-1)
    c_ref, m_ref = bin_mean(g, lats, lons, data, "sorted")
    c_pk, m_pk = bin_mean(g, lats, lons, data, "sorted_packed")
    np.testing.assert_array_equal(np.asarray(c_ref), np.asarray(c_pk))
    np.testing.assert_array_equal(np.asarray(m_ref), np.asarray(m_pk))


def test_window_tiled_elevation_f32_accurate():
    """The XLA window/tiled fallbacks split elevation into int+frac limbs;
    the FRACTIONAL limb must not be bf16-truncated (was up to 1e-2 per
    bin). Gate: counts + integer imagery bit-exact vs sorted, elevation
    within f32 accumulation noise of a float64 oracle."""
    import jax.numpy as jnp

    from auromat_tpu.ops.regrid import (
        _split_elev_channel,
        bin_indices,
        bin_partial_tiled,
        bin_partial_window,
    )

    rng = np.random.default_rng(10)
    h = w = 64
    lats = rng.uniform(40, 50, (h, w))
    lons = rng.uniform(-10, 10, (h, w))
    data = np.concatenate(
        [rng.integers(0, 256, (h, w, 3)).astype(np.float64),
         rng.uniform(-5, 90, (h, w, 1))], axis=-1)
    g = fixed_grid((8, 8), 40, 50, -10, 10)
    d32 = jnp.asarray(data, jnp.float32)
    # float64 oracle over the same split limbs
    dk = np.asarray(_split_elev_channel(d32), np.float64).reshape(-1, 5)
    fi, valid = bin_indices(g, jnp.ravel(jnp.asarray(lats)),
                            jnp.ravel(jnp.asarray(lons)))
    fi, valid = np.asarray(fi), np.asarray(valid)
    nb = g.n_lat * g.n_lon
    acc = np.zeros((nb, 2))
    cnt = np.zeros(nb)
    np.add.at(acc, fi[valid], dk[valid][:, 3:5])
    np.add.at(cnt, fi[valid], 1.0)
    el_oracle = ((acc[:, 0] - 90.0 * cnt) + acc[:, 1]).reshape(g.n_lat, g.n_lon)
    c0, s0 = bin_partial(g, lats, lons, d32, "sorted")
    for fn in (bin_partial_window, bin_partial_tiled):
        c1, s1 = fn(g, jnp.asarray(lats), jnp.asarray(lons), d32)
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_array_equal(np.asarray(s0[..., :3]),
                                      np.asarray(s1[..., :3]))
        dev = np.abs(el_oracle - np.asarray(s1[..., 3], np.float64)).max()
        assert dev < 1e-3, (fn.__name__, dev)


# ---------------------------------------------------------------------------
# the one-hot matmul variants (bin_partial_window / bin_partial_tiled) vs
# the sorted oracle
# ---------------------------------------------------------------------------

def synthetic_frame(n=64, m=128, lat0=60.0, lon0=-100.0, spread=0.01,
                    seed=7, holes=True, spill_rows=0):
    rng = np.random.default_rng(seed)
    lats = lat0 + np.cumsum(rng.random((n, m)) * spread, axis=0)
    lons = lon0 + np.cumsum(rng.random((n, m)) * spread, axis=1)
    if spill_rows:
        # emulate the horizon: a few rows whose cells spread far beyond any
        # 32x32 window
        lats[:spill_rows] += np.linspace(0, 20, m)[None, :]
        lons[:spill_rows] += np.linspace(0, 30, m)[None, :]
    if holes:
        yy, xx = np.mgrid[:n, :m]
        hole = (yy - n / 2) ** 2 + (xx - m / 2) ** 2 < (n / 6) ** 2
        lats[hole] = np.nan
        lons[hole] = np.nan
    # production contract: image channels are integer-valued (uint8/uint16
    # cast to float); the last channel (elevation) is arbitrary float
    data = np.round(rng.random((n, m, 4)) * 255).astype(np.float32)
    data[..., -1] = rng.random((n, m)) * 90
    return lats.astype(np.float32), lons.astype(np.float32), data


def nudge_off_edges(lats, lons, g, eps=1e-4):
    """Push samples off bin edges: the one-hot variants compute offsets in
    f32 — a sample within an f32 ulp of an edge may legitimately flip."""
    fy = (g.lat0 + g.lat_step / 2 - lats) / g.lat_step
    fx = (lons - (g.lon0 - g.lon_step / 2)) / g.lon_step
    lats = np.where(np.abs(fy - np.round(fy)) < eps, lats - g.lat_step * 4 * eps, lats)
    lons = np.where(np.abs(fx - np.round(fx)) < eps, lons + g.lon_step * 4 * eps, lons)
    return lats.astype(np.float32), lons.astype(np.float32)


def test_tiled_xla_matches_oracle():
    from auromat_tpu.ops.regrid import bin_partial_tiled, bin_partial

    lats, lons, data = synthetic_frame(spill_rows=4)
    g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats) + 0.1,
                   np.nanmin(lons), np.nanmax(lons) + 0.1)
    lats, lons = nudge_off_edges(lats, lons, g)
    cr, sr = bin_partial(g, lats, lons, data)
    c, s = bin_partial_tiled(g, lats, lons, data, "uint8")
    assert_allclose(np.asarray(c), np.asarray(cr))
    assert_allclose(np.asarray(s), np.asarray(sr), rtol=1e-4, atol=0.05)


def test_tiled_xla_full_mode():
    from auromat_tpu.ops.regrid import bin_partial_tiled, bin_partial

    lats, lons, data = synthetic_frame()
    rng = np.random.default_rng(5)
    data = rng.random(data.shape).astype(np.float32) * 65535
    g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats) + 0.1,
                   np.nanmin(lons), np.nanmax(lons) + 0.1)
    lats, lons = nudge_off_edges(lats, lons, g)
    cr, sr = bin_partial(g, lats, lons, data)
    c, s = bin_partial_tiled(g, lats, lons, data, "full")
    assert_allclose(np.asarray(c), np.asarray(cr))
    m = np.asarray(cr) > 0
    rel = np.abs(np.asarray(s)[m] - np.asarray(sr)[m]) / np.maximum(np.asarray(sr)[m], 1)
    assert rel.max() < 1e-4


def test_window_xla_matches_oracle():
    from auromat_tpu.ops.regrid import bin_partial_window, bin_partial

    lats, lons, data = synthetic_frame(n=128, m=192, spill_rows=6)
    g = fixed_grid(25, np.nanmin(lats), np.nanmax(lats) + 0.1,
                   np.nanmin(lons), np.nanmax(lons) + 0.1)
    lats, lons = nudge_off_edges(lats, lons, g)
    cr, sr = bin_partial(g, lats, lons, data)
    c, s = bin_partial_window(g, lats, lons, data, "uint8")
    assert_allclose(np.asarray(c), np.asarray(cr))
    assert_allclose(np.asarray(s), np.asarray(sr), rtol=1e-4, atol=0.05)


@pytest.mark.slow
class TestBinNearest:
    """Device nearest-sample resampling (seeding + jump-flood Voronoi) vs
    the scipy KD-tree oracle."""

    @staticmethod
    def _case(seed=0, n=1500):
        rng = np.random.default_rng(seed)
        lats = 50 + rng.random(n) * 5
        lons = -110 + rng.random(n) * 7
        data = rng.random((n, 3)).astype(np.float32)
        lats[rng.random(n) < 0.05] = np.nan  # masked samples
        grid = GridSpec(56, 72, 55.5, -109.75, 0.1, 0.1)
        return grid, lats, lons, data

    def test_matches_scipy_kdtree(self):
        import scipy.interpolate

        from auromat_tpu.ops.regrid import bin_nearest

        grid, lats, lons, data = self._case()
        ok = ~np.isnan(lats)
        ref = scipy.interpolate.griddata(
            (lats[ok], lons[ok]), data[ok],
            (grid.lat_centers[:, None], grid.lon_centers[None, :]),
            method="nearest")
        # oversample=4 behaves the same, better (99%+); excluded here to
        # keep the CPU-interpret suite time down
        for oversample, floor in ((1, 0.88), (2, 0.95)):
            dg, d2 = bin_nearest(grid, lats, lons, data,
                                 oversample=oversample)
            dg = np.asarray(dg)
            assert np.isfinite(dg).all()  # global Voronoi fills everywhere
            match = np.all(dg == ref, axis=-1)
            assert match.mean() > floor, (oversample, match.mean())
            # every winning value IS a real sample's value
            flat = dg.reshape(-1, 3)
            sample_set = {tuple(v) for v in data[ok]}
            miss = [tuple(v) for v in flat[~match.ravel()]]
            assert all(v in sample_set for v in miss)

    def test_no_valid_samples(self):
        from auromat_tpu.ops.regrid import bin_nearest

        grid, lats, lons, data = self._case()
        lats = np.full_like(lats, np.nan)
        dg, d2 = bin_nearest(grid, lats, lons, data)
        assert np.isinf(np.asarray(d2)).all()


class TestBinTakeBest:
    def test_matches_numpy_argmin_oracle(self):
        from auromat_tpu.ops.regrid import bin_indices, bin_take_best

        rng = np.random.default_rng(7)
        n = 300  # sparse vs the 20x20 grid: leaves some cells empty
        lats = rng.uniform(50.0, 55.0, n)
        lons = rng.uniform(-105.0, -100.0, n)
        lats[::37] = np.nan  # masked samples never win
        pri = rng.uniform(-90.0, 0.0, n).astype(np.float32)
        data = rng.uniform(0, 255, (n, 3)).astype(np.float32)
        g = fixed_grid(4, 50.0, 55.0, -105.0, -100.0)

        best, bp = map(np.asarray, bin_take_best(g, lats, lons, pri, data))

        flat_idx, valid = map(np.asarray, bin_indices(g, lats, lons))
        oracle = np.full((g.n_lat, g.n_lon, 3), np.nan, np.float32)
        opri = np.full((g.n_lat, g.n_lon), np.inf, np.float32)
        for i in range(n):
            if not valid[i]:
                continue
            iy, ix = divmod(int(flat_idx[i]), g.n_lon)
            if pri[i] < opri[iy, ix]:
                opri[iy, ix] = pri[i]
                oracle[iy, ix] = data[i]
        assert np.isnan(oracle).any() and not np.isnan(oracle).all()
        assert np.array_equal(np.isnan(best), np.isnan(oracle))
        m = ~np.isnan(oracle)
        assert np.array_equal(best[m], oracle[m])
        assert np.array_equal(bp, opri)

    def test_plan_apply_matches_bin_take_best(self):
        """The planned compositor (sort once per static geometry, gather
        per exposure — the ASI production cadence) is bit-identical to
        bin_take_best, including NaN payloads, priority ties (stable
        sort) and empty cells."""
        from auromat_tpu.ops.regrid import (apply_take_best, bin_take_best,
                                            plan_take_best)

        rng = np.random.default_rng(11)
        n = 400
        lats = rng.uniform(50.0, 55.0, n)
        lons = rng.uniform(-105.0, -100.0, n)
        lats[::29] = np.nan
        pri = rng.uniform(-90.0, 0.0, n).astype(np.float32)
        pri[::5] = pri[0]  # exact ties exercise the stable-sort order
        g = fixed_grid(4, 50.0, 55.0, -105.0, -100.0)
        plan = plan_take_best(g, lats, lons, pri)
        for seed in (0, 1):
            data = rng.uniform(0, 255, (n, 3)).astype(np.float32)
            data[seed::17, 1] = np.nan  # NaN payload at valid coords
            ref, refp = map(np.asarray,
                            bin_take_best(g, lats, lons, pri, data))
            got = np.asarray(apply_take_best(plan, data))
            assert np.array_equal(np.isnan(got), np.isnan(ref))
            m = ~np.isnan(ref)
            assert np.array_equal(got[m], ref[m])
            assert np.array_equal(np.asarray(plan[2]), refp)
        # a mismatched exposure (cropped/re-binned geometry) must fail
        # fast — jax's clamped gather would composite garbage silently
        with pytest.raises(ValueError, match="re-plan"):
            apply_take_best(plan, np.zeros((n - 3, 3), np.float32))
        # ... including through a jit boundary (the production pattern:
        # bench.py jits apply_take_best with the plan as an argument).
        # TakeBestPlan keeps n_samples in the static treedef so the
        # check cannot be traced away.
        import jax

        jitted = jax.jit(apply_take_best)
        good = np.asarray(jitted(plan, data))
        m = ~np.isnan(good)
        ref = np.asarray(apply_take_best(plan, data))
        assert np.array_equal(good[m], ref[m])
        with pytest.raises(ValueError, match="re-plan"):
            jitted(plan, np.zeros((n - 3, 3), np.float32))

    def test_nan_payload_survives(self):
        """A winning sample's NaN payload channel stays NaN (matches the
        masked-array semantics of the draw-layer compositing it replaces)."""
        from auromat_tpu.ops.regrid import bin_take_best

        g = fixed_grid(1, 50.0, 52.0, -105.0, -103.0)
        lats = np.array([50.5, 50.5])
        lons = np.array([-104.5, -104.5])
        pri = np.array([0.0, 1.0])
        data = np.array([[np.nan, 7.0], [3.0, 4.0]])
        best, bp = map(np.asarray, bin_take_best(g, lats, lons, pri, data))
        occ = np.argwhere(np.isfinite(bp))
        assert len(occ) == 1
        iy, ix = occ[0]
        assert np.isnan(best[iy, ix, 0]) and best[iy, ix, 1] == 7.0


@pytest.mark.slow
class TestInterpLinearStructured:
    """Device linear interpolation by Newton mesh inversion + bilinear
    sampling (the device replacement for scipy.griddata 'linear')."""

    @staticmethod
    def _affine_mesh(h=40, w=60):
        i = np.arange(h, dtype=np.float64)[:, None]
        j = np.arange(w, dtype=np.float64)[None, :]
        lat = 58.0 - 0.1 * i + 0.02 * j
        lon = -110.0 + 0.015 * i + 0.12 * j
        return np.broadcast_to(lat, (h, w)).copy(), \
            np.broadcast_to(lon, (h, w)).copy()

    def test_reproduces_affine_fields_exactly(self):
        """Both triangle-linear (scipy) and quad-bilinear interpolation
        reproduce locally-affine data exactly; on an affine mesh the
        Newton inversion is exact after one step, so cells inside the
        footprint must match the analytic field to rounding."""
        from auromat_tpu.ops.regrid import GridSpec, interp_linear_structured

        lat, lon = self._affine_mesh()
        f = 3.0 + 0.5 * lat - 0.25 * lon
        data = np.stack([f, np.full_like(f, 7.25)], axis=-1)
        grid = GridSpec(28, 38, 56.5, -109.0, 0.1, 0.1)
        out, pos = interp_linear_structured(grid, lat, lon, data)
        out = np.asarray(out)
        ok = ~np.isnan(out[..., 0])
        assert ok.sum() > 500
        cy = grid.lat_centers[:, None] + 0 * grid.lon_centers[None, :]
        cx = grid.lon_centers[None, :] + 0 * grid.lat_centers[:, None]
        expect = 3.0 + 0.5 * cy - 0.25 * cx
        np.testing.assert_allclose(out[..., 0][ok], expect[ok], atol=1e-9)
        np.testing.assert_allclose(out[..., 1][ok], 7.25, atol=1e-12)

    def test_matches_scipy_on_smooth_data(self):
        """Curved mesh + smooth data: quad-bilinear and triangle-linear
        weightings both approximate to O(cell^2) — results must agree to
        a small tolerance over the shared valid cells."""
        import scipy.interpolate

        from auromat_tpu.ops.regrid import GridSpec, interp_linear_structured

        h, w = 40, 60
        i = np.arange(h, dtype=np.float64)[:, None]
        j = np.arange(w, dtype=np.float64)[None, :]
        lat = 58.0 - 0.1 * i + 0.02 * j + 1e-4 * (i - 20) ** 2 / 20
        lon = -110.0 + 0.015 * i + 0.12 * j + 2e-4 * (j - 30) ** 2 / 30
        val = np.sin(np.deg2rad(4 * lat)) * np.cos(np.deg2rad(3 * lon))
        grid = GridSpec(28, 38, 56.5, -109.0, 0.1, 0.1)
        out, _ = interp_linear_structured(grid, lat, lon, val[..., None])
        out = np.asarray(out)[..., 0]
        ref = scipy.interpolate.griddata(
            (lat.ravel(), lon.ravel()), val.ravel(),
            (grid.lat_centers[:, None], grid.lon_centers[None, :]),
            method="linear")
        both = ~np.isnan(out) & ~np.isnan(ref)
        assert both.sum() > 500
        np.testing.assert_allclose(out[both], ref[both], atol=2e-4)

    def test_nan_hole_masks_touching_cells(self):
        from auromat_tpu.ops.regrid import GridSpec, interp_linear_structured

        lat, lon = self._affine_mesh()
        lat[18:22, 28:33] = np.nan
        lon[18:22, 28:33] = np.nan
        f = lat + lon
        grid = GridSpec(28, 38, 56.5, -109.0, 0.1, 0.1)
        out, pos = interp_linear_structured(grid, lat, lon, f[..., None])
        out = np.asarray(out)[..., 0]
        ok = ~np.isnan(out)
        assert ok.sum() > 400
        # the hole exists in the output but does not swallow the frame
        assert (~ok).sum() > 0
        cy = grid.lat_centers[:, None] + 0 * grid.lon_centers[None, :]
        cx = grid.lon_centers[None, :] + 0 * grid.lat_centers[:, None]
        np.testing.assert_allclose(out[ok], (cy + cx)[ok], atol=1e-9)


@pytest.mark.slow
class TestInterpCubicStructured:
    def test_reproduces_affine_fields_exactly(self):
        """Catmull-Rom has linear precision: affine data on an affine mesh
        must come back exact, same gate as the linear path."""
        from auromat_tpu.ops.regrid import GridSpec, interp_cubic_structured

        lat, lon = TestInterpLinearStructured._affine_mesh()
        f = 3.0 + 0.5 * lat - 0.25 * lon
        grid = GridSpec(28, 38, 56.5, -109.0, 0.1, 0.1)
        out, _ = interp_cubic_structured(grid, lat, lon, f[..., None])
        out = np.asarray(out)[..., 0]
        ok = ~np.isnan(out)
        assert ok.sum() > 500
        cy = grid.lat_centers[:, None] + 0 * grid.lon_centers[None, :]
        cx = grid.lon_centers[None, :] + 0 * grid.lat_centers[:, None]
        np.testing.assert_allclose(out[ok], (3.0 + 0.5 * cy - 0.25 * cx)[ok],
                                   atol=1e-9)

    def test_beats_linear_on_smooth_data(self):
        """On a smooth field the bicubic sample error must be far below
        the bilinear one (the point of the method): gate the error ratio
        against the analytic field."""
        from auromat_tpu.ops.regrid import (GridSpec,
                                            interp_cubic_structured,
                                            interp_linear_structured)

        h, w = 40, 60
        i = np.arange(h, dtype=np.float64)[:, None]
        j = np.arange(w, dtype=np.float64)[None, :]
        lat = np.broadcast_to(58.0 - 0.1 * i + 0.02 * j, (h, w)).copy()
        lon = np.broadcast_to(-110.0 + 0.015 * i + 0.12 * j, (h, w)).copy()
        ffun = lambda la, lo: np.sin(np.deg2rad(60 * la)) * \
            np.cos(np.deg2rad(45 * lo))
        val = ffun(lat, lon)
        grid = GridSpec(28, 38, 56.5, -109.0, 0.1, 0.1)
        oc, _ = interp_cubic_structured(grid, lat, lon, val[..., None])
        ol, _ = interp_linear_structured(grid, lat, lon, val[..., None])
        oc = np.asarray(oc)[..., 0]
        ol = np.asarray(ol)[..., 0]
        cy = grid.lat_centers[:, None] + 0 * grid.lon_centers[None, :]
        cx = grid.lon_centers[None, :] + 0 * grid.lat_centers[:, None]
        truth = ffun(cy, cx)
        both = ~np.isnan(oc) & ~np.isnan(ol)
        assert both.sum() > 400
        err_c = np.abs(oc - truth)[both].max()
        err_l = np.abs(ol - truth)[both].max()
        assert err_c < err_l / 5, (err_c, err_l)
