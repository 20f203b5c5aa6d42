"""Fused georef + regrid step (the GPU binning route) vs the sorted XLA
oracle, plus the f32-vs-f64 bin-assignment error budget it relies on."""

import os

import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax.numpy as jnp

from auromat_tpu.coordinates.wcs import TanWcs
from auromat_tpu.io import fits
from auromat_tpu.ops.georef import (DynGeorefParams, GeorefParams,
                                    georef_latlon_dyn, georeference_points)
from auromat_tpu.backend import GPU_BIN_METHOD
from auromat_tpu.ops.georegrid import georegrid_mean, georegrid_partial
from auromat_tpu.ops.regrid import bin_indices, bin_mean, fixed_grid

RES = os.path.join(os.path.dirname(__file__), "resources")


def small_params(w=128, h=96):
    """Real ISS calibration scaled down to a small pixel grid."""
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    base = GeorefParams.from_wcs(
        TanWcs(header),
        fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_photo_time(header),
        altitude=110.0,
    )
    scale = base.width / w
    return GeorefParams(
        width=w, height=h,
        cd=tuple(tuple(v * scale for v in row) for row in base.cd),
        px_ref=base.px_ref / scale, py_ref=base.py_ref / scale,
        rotmat=base.rotmat, camera_pos=base.camera_pos,
        altitude=base.altitude,
        mat_j2000_to_geo=base.mat_j2000_to_geo,
        mat_j2000_to_sm=base.mat_j2000_to_sm,
    ), base


@pytest.fixture(scope="module")
def setup():
    params, _ = small_params()
    dyn = DynGeorefParams.from_static(params, dtype=jnp.float32)
    h, w = params.height, params.width
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (3, h, w)).astype(np.float32)
    grid = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)
    return params, dyn, img, grid


def oracle(dyn, img, grid, mask=None):
    h, w = img.shape[1:]
    px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    py = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    out = georef_latlon_dyn(dyn, px, py, dtype=jnp.float32,
                            with_elevation=True)
    lat, lon = out["lat"], out["lon"]
    if mask is not None:
        lat = jnp.where(mask, jnp.nan, lat)
        lon = jnp.where(mask, jnp.nan, lon)
    data = jnp.concatenate(
        [jnp.transpose(img, (1, 2, 0)), out["elevation"][..., None]], axis=-1)
    return bin_mean(grid, lat, lon, data, "sorted"), out


class TestGeoregrid:
    def test_matches_oracle(self, setup):
        _, dyn, img, grid = setup
        (count_ref, means_ref), out = oracle(dyn, img, grid)
        count, means = georegrid_mean(grid, dyn, img,
                                      bin_method=GPU_BIN_METHOD)
        count, means = np.asarray(count), np.asarray(means)
        count_ref, means_ref = np.asarray(count_ref), np.asarray(means_ref)
        assert count.sum() > 0
        # the fused path and the oracle are SEPARATE XLA programs; on CPU
        # their f32 georef chains round differently (fma contraction), so
        # pixels sitting on a cell edge may flip to the neighbouring cell.
        # Allow exactly that class of difference: +-1 count in a tiny cell
        # set.
        assert count.sum() == count_ref.sum()
        d = count - count_ref
        assert np.abs(d).max() <= 1
        assert (d != 0).mean() < 1e-2, (d != 0).mean()
        same = (d == 0) & (count > 0)
        assert np.array_equal(np.isnan(means[same]), np.isnan(means_ref[same]))
        ok = same[..., None] & ~np.isnan(means_ref)
        assert_allclose(means[ok], means_ref[ok], rtol=1e-3, atol=0.05)

    def test_mask_excludes_pixels(self, setup):
        _, dyn, img, grid = setup
        h, w = img.shape[1:]
        mask = np.zeros((h, w), dtype=bool)
        mask[: h // 2] = True
        (count_ref, _), _ = oracle(dyn, img, grid, jnp.asarray(mask))
        count, _ = georegrid_mean(grid, dyn, img, mask=jnp.asarray(mask),
                                  bin_method=GPU_BIN_METHOD)
        count, count_ref = np.asarray(count), np.asarray(count_ref)
        assert count.sum() == count_ref.sum()
        assert np.abs(count - count_ref).max() <= 1

    def test_f32_bin_assignment_budget(self, setup):
        """The documented error budget: vs the f64 chain, only pixels
        within the f32 chain error (measured ~4e-5 deg) of a cell edge
        can flip bins — a ~1.4e-3 fraction at 100 arcsec cells."""
        params, dyn, img, grid = setup
        h, w = params.height, params.width
        px, py = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        lat64, lon64 = georeference_points(params, px, py, dtype=jnp.float64)
        i64, v64 = bin_indices(grid, jnp.ravel(lat64), jnp.ravel(lon64))
        px32, py32 = px.astype(np.float32), py.astype(np.float32)
        out = georef_latlon_dyn(dyn, jnp.asarray(px32), jnp.asarray(py32),
                                dtype=jnp.float32)
        i32, v32 = bin_indices(grid, jnp.ravel(out["lat"]),
                               jnp.ravel(out["lon"]))
        i64, i32 = np.asarray(i64), np.asarray(i32)
        v = np.asarray(v64) & np.asarray(v32)
        assert v.sum() > 1000
        flips = (i64[v] != i32[v]).mean()
        assert flips < 5e-3, flips
        # validity itself must agree except at the same edge-band level
        assert (np.asarray(v64) != np.asarray(v32)).mean() < 5e-3


def assert_flip_class(count, count_ref):
    """Equal totals, and at most a +-1 count in a tiny set of cells: the
    edge-pixel flips of two separately compiled f32 georef chains."""
    assert count.sum() == count_ref.sum()
    d = count - count_ref
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() < 1e-2, (d != 0).mean()


class TestFusedStepGridEdges:
    """The fused step at the edges of its input and of its grid: a frame
    with no valid sample, and grids whose first or last row cuts through
    the frame's footprint (samples beyond the edge are dropped, the edge
    row itself is kept) — the GPU route against the sorted oracle."""

    def test_empty_input(self, setup):
        from auromat_tpu.parallel.mosaic import null_georef_params

        params, _, img, grid = setup
        dyn = DynGeorefParams.from_static(null_georef_params(params),
                                          dtype=jnp.float32)
        count, sums = (np.asarray(a) for a in georegrid_partial(
            grid, dyn, img, bin_method=GPU_BIN_METHOD))
        assert count.shape == (grid.n_lat, grid.n_lon)
        assert np.all(count == 0)
        assert np.all(sums == 0)  # zeros, not NaN

    @pytest.mark.parametrize("row", [0, -1])  # first / LAST grid row
    def test_single_boundary_row(self, setup, row):
        _, dyn, img, _ = setup
        # the frame spans ~48..61 deg latitude; row 0 is the NORTH edge
        lat_lo, lat_hi = (44.0, 54.0) if row == 0 else (54.0, 66.0)
        grid = fixed_grid((36, 25), lat_lo, lat_hi, -112.0, -91.0)
        count, sums = (np.asarray(a) for a in georegrid_partial(
            grid, dyn, img, bin_method=GPU_BIN_METHOD))
        count_ref, sums_ref = (np.asarray(a) for a in georegrid_partial(
            grid, dyn, img, bin_method="sorted"))
        assert count[row].sum() > 0  # the edge row is populated
        assert_flip_class(count, count_ref)
        same = count == count_ref
        assert np.array_equal(sums[same][:, :3], sums_ref[same][:, :3])
        # fewer samples than the whole frame: the rest fell off the edge
        (full, _), _ = oracle(dyn, img, fixed_grid((36, 25), 40.0, 70.0,
                                                   -112.0, -91.0))
        assert 0 < count.sum() < np.asarray(full).sum()
