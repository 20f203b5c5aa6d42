"""Sharded batch georeferencing + mosaic regrid over a jax.sharding.Mesh.

The full pipeline step = batched georef (vmap over frames) + multi-channel
mean regrid with a cross-shard psum of (count, sums) partial bins. Frames
shard over the ``dp`` mesh axis, image rows over ``sp``; the reduction rides
the collectives inserted for the psum. This is the device replacement for
the reference's host-process parallelism (auromat/mapping/spacecraft.py:
308-377) and the scale path for mission-scale mosaics (BASELINE configs 4-5).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from auromat_tpu.backend import mean_bin_method
from auromat_tpu.ops.georef import DynGeorefParams, georef_latlon_dyn
from auromat_tpu.ops.regrid import (_BIN_METHODS, GridSpec, bin_indices,
                                    bin_partial, finalize_mean, round_up)


def make_mesh(devices=None, dp=None, sp=None):
    """Build a (dp, sp) mesh over the given (or all) devices.

    Picks the most square-ish factorisation when sizes are not given.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None and sp is None:
        sp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                sp = cand
                break
        dp = n // sp
    elif dp is None:
        assert n % sp == 0, (n, sp)
        dp = n // sp
    elif sp is None:
        assert n % dp == 0, (n, dp)
        sp = n // dp
    assert dp * sp == len(devices), (dp, sp, len(devices))
    dev = np.asarray(devices).reshape(dp, sp)
    return Mesh(dev, axis_names=("dp", "sp"))


def _local_pixel_grid(height, width, rows_per_shard, dtype):
    """Pixel-centre grid for this shard's row block (sp axis offset)."""
    row0 = jax.lax.axis_index("sp") * rows_per_shard
    ys = row0 + jax.lax.broadcasted_iota(jnp.int32, (rows_per_shard, width), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (rows_per_shard, width), 1)
    return xs.astype(dtype), ys.astype(dtype)


def _dyn_dp_spec():
    """P('dp') over every DynGeorefParams leaf (frames sharded over dp)."""
    return jax.tree.map(lambda _: P("dp"), DynGeorefParams(
        *[0.0] * len(DynGeorefParams._fields)))


def make_sharded_mosaic_step(mesh: Mesh, grid: GridSpec, height, width,
                             channels=3, dtype=jnp.float32,
                             with_elevation=True, bin_method=None):
    """Build the jitted full pipeline step over a mesh.

    step(dyn_params, imgs) -> (count, means)
      dyn_params: DynGeorefParams stacked over frames (leading axis B)
      imgs: (B, height, width, channels) float
      count: (n_lat, n_lon) replicated; means: (n_lat, n_lon, channels[+1])
      (last channel = mean elevation when with_elevation)

    B must divide by mesh 'dp', height by 'sp'. ``bin_method`` None takes
    the device's route (:func:`auromat_tpu.backend.mean_bin_method`).
    """
    if bin_method is None:
        bin_method = mean_bin_method()
    dp_n = mesh.shape["dp"]
    sp_n = mesh.shape["sp"]
    assert height % sp_n == 0, (height, sp_n)
    rows_per_shard = height // sp_n

    def shard_fn(dyn_local, imgs_local):
        # dyn_local: leaves with leading axis B/dp; imgs_local (B/dp, h/sp, w, C)
        px, py = _local_pixel_grid(height, width, rows_per_shard, dtype)

        def per_frame(d, img):
            out = georef_latlon_dyn(d, px, py, dtype=dtype,
                                    with_elevation=with_elevation)
            data = img
            if with_elevation:
                data = jnp.concatenate([img, out["elevation"][..., None]], axis=-1)
            return bin_partial(grid, out["lat"], out["lon"], data, bin_method)

        counts, sums = jax.vmap(per_frame)(dyn_local, imgs_local)
        count = jnp.sum(counts, axis=0)
        sums = jnp.sum(sums, axis=0)
        count = jax.lax.psum(count, ("dp", "sp"))
        sums = jax.lax.psum(sums, ("dp", "sp"))
        return count, finalize_mean(count, sums)

    dyn_spec = _dyn_dp_spec()
    step = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(dyn_spec, P("dp", "sp")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(step)

    def run(dyn_params, imgs):
        # validate the documented contract up front — a violation otherwise
        # surfaces as an opaque sharding shape error deep inside shard_map
        b = imgs.shape[0]
        if b % dp_n != 0:
            raise ValueError(f"batch {b} must divide by mesh dp={dp_n}")
        if imgs.shape[1:] != (height, width, channels):
            raise ValueError(
                f"imgs shape {imgs.shape[1:]} != ({height}, {width}, {channels})"
            )
        return jitted(dyn_params, imgs)

    return run


def make_grid_sharded_mosaic_step(mesh: Mesh, grid: GridSpec, height, width,
                                  channels=3, dtype=jnp.float32,
                                  with_elevation=True, bin_method=None,
                                  chunk_rows=None, finalize=True,
                                  min_elevation=None):
    """Mission-scale mosaic step: the GRID is sharded, not just the samples.

    ``make_sharded_mosaic_step`` psums dense full-grid partials onto every
    device — fine for regional grids, but a 0.05 deg global mosaic
    (3600 x 7200 x C f32, ~600 MB; BASELINE config 5) should not be
    all-reduced onto every device. Here every device OWNS one latitude
    band of the grid (band = ceil(n_lat / n_devices) rows, assigned by
    linear mesh index); partial bins are routed with ``lax.psum_scatter``
    (reduce-scatter — each grid element crosses the interconnect exactly
    once, vs n_dev times for the psum variant), in row-chunks of
    n_dev * chunk_rows rows (default: ~1/n_dev of the full grid).

    ``bin_method`` is an ``ops.regrid._BIN_METHODS`` key; None takes the
    device's route (:func:`auromat_tpu.backend.mean_bin_method`). The
    'sorted' route sorts the shard's samples ONCE in chunk-major key
    order and answers each chunk with a range query, so its working set
    stays at ~1/n_dev of the grid. Every other route bins the shard's
    samples ONCE into the band-padded full grid and slices that
    accumulator chunk by chunk for the routing: one pass over the samples,
    at the cost of a full-grid accumulator per device (~520 MB for the
    0.05 deg global mosaic at f32).

    step(dyn_params, imgs) -> (count, means) as GLOBAL jax.Arrays of shape
    (band * n_dev, n_lon[, C]) sharded row-wise over the mesh (each device
    holds only its band; rows >= n_lat are padding). Slice [:n_lat] on the
    host, or keep sharded for downstream sharded consumers.

    ``finalize=False`` returns (count, sums) partials instead of
    (count, means) — counts and sums are LINEAR, so multi-burst sequences
    accumulate partials across step calls (same sharding) and finalize
    once at the end (:func:`mosaic_sequence`).

    ``min_elevation`` (degrees) masks SAMPLES below the threshold before
    binning — the device equivalent of ``Mapping.maskedByElevation``
    before ``resample`` (reference cli/convert.py:187-196 semantics:
    horizon-distorted pixels never enter the bins, unlike masking the
    per-cell mean elevation afterwards). Requires ``with_elevation``.

    Reference scale anchor: auromat's convert pipeline writes one sequence
    = 172 GB (docs/userguide/index.rst:66-78); the hot loop this keeps fast
    at mosaic scale is auromat/resample.py:328-351; SURVEY.md P6/P7.
    """
    dp_n = mesh.shape["dp"]
    sp_n = mesh.shape["sp"]
    n_dev = dp_n * sp_n
    assert height % sp_n == 0, (height, sp_n)
    rows_per_shard = height // sp_n

    n_lon = grid.n_lon
    band = round_up(-(-grid.n_lat // n_dev), 8)  # 8-aligned rows per device
    if chunk_rows is None:
        chunk_rows = max(8, round_up(band // n_dev, 8))
    chunk_rows = min(chunk_rows, band)
    n_chunks = -(-band // chunk_rows)
    band_pad = n_chunks * chunk_rows
    n_ch = channels + (1 if with_elevation else 0)
    if min_elevation is not None and not with_elevation:
        raise ValueError("min_elevation needs with_elevation=True "
                         "(the mask tests the per-sample elevation)")
    if bin_method is None:
        bin_method = mean_bin_method()
    if bin_method not in _BIN_METHODS:
        raise ValueError(f"unknown bin_method {bin_method!r}; expected one "
                         f"of {sorted(_BIN_METHODS)}")
    bin_fn = _BIN_METHODS[bin_method]

    if n_dev == 1:
        # reduce-scatter over a singleton axis pair is the identity, but
        # XLA still emits a real reduce-scatter (a full copy of the
        # routed grid); elide it at trace time
        def _scatter(x):
            return x
    else:
        def _scatter(x):
            return jax.lax.psum_scatter(x, ("dp", "sp"),
                                        scatter_dimension=0, tiled=True)

    def shard_fn(dyn_local, imgs_local):
        px, py = _local_pixel_grid(height, width, rows_per_shard, dtype)

        def per_frame(d, img):
            out = georef_latlon_dyn(d, px, py, dtype=dtype,
                                    with_elevation=with_elevation)
            elev = out["elevation"] if with_elevation else None
            return out["lat"], out["lon"], img, elev

        lat, lon, img_b, elev_b = jax.vmap(per_frame)(dyn_local, imgs_local)
        flat_idx, valid = bin_indices(grid, jnp.ravel(lat), jnp.ravel(lon))
        if min_elevation is not None:
            # pre-binning sample mask (Mapping.maskedByElevation-before-
            # resample semantics); NaN elevation compares False -> stays
            # invalid
            valid = valid & (jnp.ravel(elev_b) >= min_elevation)
        iy = (flat_idx // n_lon).astype(jnp.int32)
        ix = (flat_idx % n_lon).astype(jnp.int32)

        n_rows_stacked = n_dev * chunk_rows
        chunk_bins = n_rows_stacked * n_lon

        data = img_b
        if with_elevation:
            data = jnp.concatenate([img_b, elev_b[..., None]], axis=-1)
        data2d = jnp.reshape(data, (-1, n_ch)).astype(dtype)
        data2d = jnp.where(valid[:, None], data2d, 0.0)
        # NaN data at VALID coords (NaN-masked imagery) must be zeroed: a
        # raw NaN riding the sorted path's prefix sums would corrupt every
        # bin after it in sort order (same scrub as bin_partial)
        data2d = jnp.where(jnp.isnan(data2d), 0.0, data2d)

        if bin_method == "sorted":
            # sort ONCE in chunk-major key order; each chunk then costs one
            # binary-search range query over the shared prefix sums (the
            # per-chunk re-sort variant paid ~n_dev full payload sorts)
            from auromat_tpu.ops.regrid import (_accumulate_sorted_range,
                                                sorted_prefix_state)

            band_id = iy // band
            rib = iy - band_id * band  # row inside the destination band
            chunk_id = rib // chunk_rows
            key = (chunk_id * n_rows_stacked
                   + band_id * chunk_rows
                   + (rib - chunk_id * chunk_rows)) * n_lon + ix
            key = jnp.where(valid, key, n_chunks * chunk_bins)
            # no explicit valid payload: invalid samples are keyed outside
            # every chunk range, so _accumulate_sorted_range's column 0
            # (range count) IS the valid count — sorting a redundant
            # payload array would add a full extra sort pass
            sidx, state = sorted_prefix_state(key, data2d)

            def chunk_acc(c):
                return _accumulate_sorted_range(sidx, state, c * chunk_bins,
                                                chunk_bins, dtype)
        else:
            # bin ONCE into the band-padded natural grid (rows >= n_lat
            # never receive a sample), then slice the accumulated GRID
            # chunk by chunk: (n_dev * band, n_lon) rows reshape to
            # (n_dev, band, ...) without a copy, and only a band that
            # n_chunks does not divide exactly pays a pad
            n_pad_bins = n_dev * band * n_lon
            flat = jnp.where(valid, flat_idx, n_pad_bins)
            dense = bin_fn(flat, valid.astype(dtype), data2d, n_pad_bins,
                           n_ch).astype(dtype)
            dense = dense.reshape(n_dev, band, n_lon, 1 + n_ch)
            if band_pad != band:
                dense = jnp.pad(dense, ((0, 0), (0, band_pad - band),
                                        (0, 0), (0, 0)))

            def chunk_acc(c):
                sl = slice(c * chunk_rows, (c + 1) * chunk_rows)
                return dense[:, sl]

        cnts, smss = [], []
        for c in range(n_chunks):
            # reduce-scatter: device d receives rows [d*chunk_rows, ...)
            # of the chunk (linear mesh order matches the band assignment
            # and out_specs)
            acc = _scatter(chunk_acc(c).reshape(n_rows_stacked, n_lon,
                                                1 + n_ch))
            cnts.append(acc[..., 0])
            smss.append(acc[..., 1:])
        out_count = (cnts[0] if n_chunks == 1
                     else jnp.concatenate(cnts))[:band]
        out_sums = (smss[0] if n_chunks == 1
                    else jnp.concatenate(smss))[:band]
        return out_count, (finalize_mean(out_count, out_sums)
                           if finalize else out_sums)

    dyn_spec = _dyn_dp_spec()
    step = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(dyn_spec, P("dp", "sp")),
        out_specs=(P(("dp", "sp")), P(("dp", "sp"))),
        check_vma=False,
    )
    jitted = jax.jit(step)

    def run(dyn_params, imgs):
        # same up-front contract validation as make_sharded_mosaic_step —
        # a violation otherwise surfaces as an opaque shard_map error
        b = imgs.shape[0]
        if b % dp_n != 0:
            raise ValueError(f"batch {b} must divide by mesh dp={dp_n}")
        if imgs.shape[1:] != (height, width, channels):
            raise ValueError(
                f"imgs shape {imgs.shape[1:]} != ({height}, {width}, "
                f"{channels})")
        return jitted(dyn_params, imgs)

    # expose the jit AOT surface (config-5 tests/tools compile-inspect
    # the step via .lower(...).compile())
    run.lower = jitted.lower
    run.jitted = jitted
    return run


def sharded_batch_georef(mesh: Mesh, height, width, dtype=jnp.float32,
                         with_elevation=True, with_mlatmlt=False):
    """Build a jitted batched georef: frames over dp, rows over sp.

    fn(dyn_params) -> dict of (B, height, width) arrays (lat, lon, ...).
    Outputs keep the same sharding (no communication at all — per-pixel math
    is embarrassingly parallel).
    """
    sp_n = mesh.shape["sp"]
    assert height % sp_n == 0
    rows_per_shard = height // sp_n

    def shard_fn(dyn_local):
        px, py = _local_pixel_grid(height, width, rows_per_shard, dtype)
        return jax.vmap(
            lambda d: georef_latlon_dyn(d, px, py, dtype=dtype,
                                        with_elevation=with_elevation,
                                        with_mlatmlt=with_mlatmlt)
        )(dyn_local)

    dyn_spec = _dyn_dp_spec()
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(dyn_spec,),
        out_specs=jax.tree.map(lambda _: P("dp", "sp"), {"lat": 0, "lon": 0,
                               **({"elevation": 0} if with_elevation else {}),
                               **({"mlat": 0, "mlt": 0} if with_mlatmlt else {})}),
        check_vma=False,
    )
    return jax.jit(fn)
