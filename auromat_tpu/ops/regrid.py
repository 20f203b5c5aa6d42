"""Plate-carree regridding: multi-channel mean binning on device.

Replaces the reference's histogram2d-with-weight-list rebinning
(auromat/resample.py:328-351, auromat/util/histogram.py:32-49): count, all
image channels and elevation are accumulated in ONE pass over the pixels,
then divided.

Binning routes (``_BIN_METHODS``): a direct scatter-add, which XLA lowers
to atomics on a GPU and which is the GPU route (auromat_tpu.backend); a
segment-sum over sorted bin ids; and the scatter-free sorted path with
prefix sums, which is the exact oracle and the CPU route. The one-hot
matmul variants (:func:`bin_partial_window`, :func:`bin_partial_tiled`)
are kept for comparison.

Grid alignment: all resamplings share one global grid per resolution
(reference resample.py:281-299 ``fixedGrid``) so mosaics line up cell-exact.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def round_up(x, m):
    """Smallest multiple of m >= x (tile/window padding helper)."""
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class GridSpec:
    """A fixed plate-carree grid (host-side, static under jit).

    Latitudes DEcrease along rows (north at row 0), longitudes increase along
    columns — the reference's output orientation (resample.py:228-237).
    ``lat0``/``lon0`` are the *centre* coordinates of the first (north-west)
    cell; ``lat_step`` is positive.
    """

    n_lat: int
    n_lon: int
    lat0: float
    lon0: float
    lat_step: float
    lon_step: float

    @property
    def lat_centers(self):
        return self.lat0 - np.arange(self.n_lat) * self.lat_step

    @property
    def lon_centers(self):
        return self.lon0 + np.arange(self.n_lon) * self.lon_step

    @property
    def lat_corners(self):
        return self.lat0 + self.lat_step / 2 - np.arange(self.n_lat + 1) * self.lat_step

    @property
    def lon_corners(self):
        return self.lon0 - self.lon_step / 2 + np.arange(self.n_lon + 1) * self.lon_step

    def corner_grids(self):
        """(lats, lons) 2D corner arrays of shape (n_lat+1, n_lon+1)."""
        return np.meshgrid(self.lon_corners, self.lat_corners)[::-1]

    def center_grids(self):
        return np.meshgrid(self.lon_centers, self.lat_centers)[::-1]


def fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max):
    """Align a bounding box to the global fixed grid; return a GridSpec.

    Semantics follow the reference exactly (auromat/resample.py:281-299 plus
    the first/last trimming at resample.py:229-237): the returned grid's
    *centre* rows/columns are the global grid lines strictly inside the
    aligned box (first and last alignment line dropped).

    :param px_per_deg: (lat_px_per_deg, lon_px_per_deg) or a scalar
    :param lon_min, lon_max: must NOT contain the discontinuity
    """
    try:
        lat_ppd, lon_ppd = px_per_deg
    except TypeError:
        lat_ppd = lon_ppd = float(px_per_deg)
    assert lat_ppd > 0 and lon_ppd > 0

    n_lat_all = int(round(lat_ppd * 180 + 1))
    n_lon_all = int(round(lon_ppd * 360 + 1))
    lat_all = np.linspace(-90, 90, n_lat_all)
    lon_all = np.linspace(-180, 180, n_lon_all)
    lat_lo = lat_all[np.argmax(lat_all > lat_min) - 1]
    lat_hi = lat_all[np.argmax(lat_all >= lat_max)]
    lon_lo = lon_all[np.argmax(lon_all > lon_min) - 1]
    lon_hi = lon_all[np.argmax(lon_all >= lon_max)]
    n_lat = int(round(lat_ppd * (lat_hi - lat_lo) + 1))
    n_lon = int(round(lon_ppd * (lon_hi - lon_lo) + 1))
    assert n_lat > 2 and n_lon > 2, (n_lat, n_lon)

    # canonical global steps (identical for every bbox at this resolution,
    # unlike the reference's per-bbox linspace retstep which carries float
    # jitter in the last ulps, resample.py:229-230)
    lat_step = 180.0 / (n_lat_all - 1)
    lon_step = 360.0 / (n_lon_all - 1)
    # drop the outermost centre lines (reference resample.py:232-237)
    return GridSpec(
        n_lat=n_lat - 2,
        n_lon=n_lon - 2,
        lat0=lat_hi - lat_step,
        lon0=lon_lo + lon_step,
        lat_step=lat_step,
        lon_step=lon_step,
    )


@partial(jax.jit, static_argnums=(3, 4))
def _bin_sum_segment(flat_idx, weights, data, n_bins, n_ch):
    """Sorted segment-sum accumulation: (n_bins, n_ch+1) of [count, sums...]."""
    order = jnp.argsort(flat_idx)
    sidx = flat_idx[order]
    vals = jnp.concatenate([weights[:, None], data], axis=1)[order]
    return jax.ops.segment_sum(vals, sidx, num_segments=n_bins + 1,
                               indices_are_sorted=True)[:-1]


def _two_sum(a, b):
    """Knuth error-free transformation: a+b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


_CHUNK = 4096


def _log_shift_cumsum(x, axis=-1):
    """Inclusive cumsum via log2(n) shifted adds.

    jnp.cumsum may lower to a reduce-window (O(n * window) work); the
    Hillis-Steele log-shift form is O(n log n) and exact for
    integer-valued f32 data.
    """
    n = x.shape[axis]
    shift = 1
    while shift < n:
        shifted = jnp.roll(x, shift, axis=axis)
        # zero the wrapped-around part
        idx = jnp.arange(n)
        mask = (idx >= shift)
        shape = [1] * x.ndim
        shape[axis] = n
        x = x + jnp.where(mask.reshape(shape), shifted, 0.0)
        shift *= 2
    return x


def _chunked_prefix(v):
    """Two-level prefix sums: within-chunk log-shift cumsum + compensated
    (hi, lo) chunk offsets.

    A single associative_scan over 12M elements compiles for minutes;
    cumsum over (m, 4096) chunks plus a small compensated scan
    over ~3k chunk totals compiles in seconds and keeps per-bin extraction
    accurate: the exclusive chunk offset is an error-free (hi, lo) pair, and
    within-chunk prefixes stay below ~1e6 where f32 is near-exact.

    ``v`` may be (n,) for one channel or channels-FIRST (C, n); the chunk
    axis is always last so it maps onto the 128-lane dimension.

    :returns: (inner ([C,] m, CHUNK) in-chunk inclusive prefix,
        off_h ([C,] m), off_l) such that
        inclusive_prefix[g] == off_h[g//C] + (off_l[g//C] + inner[g//C, g%C])
    """
    n = v.shape[-1]
    pad_width = ((0, 0),) * (v.ndim - 1) + ((0, (-n) % _CHUNK),)
    vp = jnp.pad(v, pad_width)
    x = vp.reshape(v.shape[:-1] + (-1, _CHUNK))
    inner = _log_shift_cumsum(x, axis=-1)
    totals = inner[..., -1]

    def combine(a, b):
        (ah, al), (bh, bl) = a, b
        s, e = _two_sum(ah, bh)
        return s, e + al + bl

    oh, ol = jax.lax.associative_scan(
        combine, (totals, jnp.zeros_like(totals)), axis=-1
    )
    zero = jnp.zeros(totals.shape[:-1] + (1,), dtype=v.dtype)
    off_h = jnp.concatenate([zero, oh[..., :-1]], axis=-1)
    off_l = jnp.concatenate([zero, ol[..., :-1]], axis=-1)
    return inner, off_h, off_l


def _searchsorted_binary(sorted_keys, queries, side="left"):
    """Vectorized binary search: a fixed ~log2(n) rounds of
    gather/compare over every query at once."""
    n = sorted_keys.shape[0]
    n_bits = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    lo = jnp.zeros(queries.shape, dtype=jnp.int32)
    hi = jnp.full(queries.shape, n, dtype=jnp.int32)

    def body(_, lh):
        lo, hi = lh
        # guard on convergence: the loop runs a FIXED n_bits iterations, and
        # an unguarded step at lo == hi == n re-tests keys[n-1] and pushes
        # lo to n+1 for queries greater than every key (bins above the max
        # occupied bin when no dump entries exist) — the out-of-range index
        # then reads clamped garbage in the prefix-sum gathers
        active = lo < hi
        mid = (lo + hi) // 2
        v = sorted_keys[jnp.minimum(mid, n - 1)]
        go_right = active & ((v < queries) if side == "left" else (v <= queries))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_bits, body, (lo, hi))
    return jnp.minimum(lo, n)


def _accumulate_sorted_range(sidx, prefix_state, bin_lo, n_bins, dtype):
    """Accumulate one contiguous bin range [bin_lo, bin_lo + n_bins) from a
    globally sorted key/prefix state (sort + prefix sums paid ONCE; each
    range query costs one extended binary search + gathers)."""
    inner, off_h, off_l = prefix_state
    bins_ext = jnp.arange(n_bins + 1, dtype=sidx.dtype) + sidx.dtype.type(bin_lo)
    starts_ext = _searchsorted_binary(sidx, bins_ext, side="left")
    starts = starts_ext[:-1]
    ends = starts_ext[1:]
    count = (ends - starts).astype(dtype)

    def prefix(pos):
        # inclusive channel prefixes at pos-1; zero when pos == 0
        idx = jnp.maximum(pos - 1, 0)
        c = idx // _CHUNK
        p = idx % _CHUNK
        ok = (pos > 0)[None, :]
        h = jnp.where(ok, off_h[:, c], 0.0)
        l = jnp.where(ok, off_l[:, c] + inner[:, c, p], 0.0)
        return h, l

    h_end, l_end = prefix(ends)
    h_sta, l_sta = prefix(starts)
    sums = (h_end - h_sta) + (l_end - l_sta)  # (n_ch, n_bins)
    return jnp.concatenate([count[:, None], sums.T], axis=1)


def sorted_prefix_state(flat_idx, data):
    """Sort keys with channel payloads and build the two-level prefix sums
    — the reusable front half of the sorted binning path. Query bin ranges
    with :func:`_accumulate_sorted_range`.

    :param data: (n, C) channel values
    :returns: (sidx sorted keys, prefix_state)
    """
    n_ch = data.shape[-1]
    operands = [flat_idx] + [data[:, c] for c in range(n_ch)]
    sorted_ops = jax.lax.sort(operands, num_keys=1)
    sidx = sorted_ops[0]
    sdata = jnp.stack(sorted_ops[1:], axis=0)  # channels-first
    return sidx, _chunked_prefix(sdata)


@partial(jax.jit, static_argnums=(2, 3))
def _accumulate_sorted(sidx, sdata, n_bins, dtype):
    """Shared tail: per-bin ranges via one extended binary search + two-level
    compensated prefix sums over already-sorted (keys, channels-first data)."""
    return _accumulate_sorted_range(sidx, _chunked_prefix(sdata), 0, n_bins,
                                    dtype)


def _bin_sum_sorted(flat_idx, weights, data, n_bins, n_ch):
    """Scatter-free accumulation: sort keys with payloads, per-bin ranges via
    vectorized binary search, sums via two-level prefix sums.

    Exact and order-independent for integer-valued channels: the oracle
    every other route is compared with.
    """
    sidx, state = sorted_prefix_state(flat_idx, data)
    return _accumulate_sorted_range(sidx, state, 0, n_bins, data.dtype)


def _bin_sum_sorted_gather(flat_idx, weights, data, n_bins, n_ch):
    """Like _bin_sum_sorted, but sorts only (key, index) pairs and gathers
    the channel payload by the sort permutation afterwards — 2 sorted arrays
    instead of 1 + n_ch, trading sort passes for one gather."""
    n = flat_idx.shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    sidx, sperm = jax.lax.sort([flat_idx, perm], num_keys=1)
    sdata = jnp.take(data.T, sperm, axis=1)  # (n_ch, n)
    return _accumulate_sorted(sidx, sdata, n_bins, data.dtype)


def _bin_sum_sorted_packed(flat_idx, weights, data, n_bins, n_ch,
                           layout="plain"):
    """_bin_sum_sorted for uint8-valued imagery + one float channel: packs
    the integer channels into ONE int32 sort operand (lossless ONLY for
    integer-valued channels in 0..255 — the caller opts in by selecting
    this method for uint8 imagery), cutting the sort payload arrays.

    Two layouts are recognised, keyed on the EXPLICIT ``layout`` the
    caller passes (an earlier version guessed from the channel count,
    which mis-packed bin_mean's taint-doubled grayscale layout
    [gray, elev, t0, t1] as [R, G, B, elev], truncating elevation):
      layout == "plain" and n_ch == 4 — [R, G, B, elev] from bin_partial
      layout == "taint" and n_ch == 8 — [R, G, B, elev, t0..t3] from
                  bin_mean, where t* are the 0/1 taint indicator channels:
                  RGB packs into bits 0..23, taint bits into bits 24..27
    Anything else falls back to the general sorted path.
    """
    f32 = data.dtype
    i32 = jnp.int32
    if layout == "plain" and n_ch == 4:
        rgb = (data[:, 0].astype(i32)
               | (data[:, 1].astype(i32) << 8)
               | (data[:, 2].astype(i32) << 16))
        sidx, srgb, selev = jax.lax.sort(
            [flat_idx, rgb, data[:, 3]], num_keys=1
        )
        sdata = jnp.stack([
            (srgb & 255).astype(f32),
            ((srgb >> 8) & 255).astype(f32),
            ((srgb >> 16) & 255).astype(f32),
            selev,
        ], axis=0)
        return _accumulate_sorted(sidx, sdata, n_bins, f32)
    if layout == "taint" and n_ch == 8:
        packed = (data[:, 0].astype(i32)
                  | (data[:, 1].astype(i32) << 8)
                  | (data[:, 2].astype(i32) << 16)
                  | (data[:, 4].astype(i32) << 24)
                  | (data[:, 5].astype(i32) << 25)
                  | (data[:, 6].astype(i32) << 26)
                  | (data[:, 7].astype(i32) << 27))
        sidx, spk, selev = jax.lax.sort(
            [flat_idx, packed, data[:, 3]], num_keys=1
        )
        sdata = jnp.stack([
            (spk & 255).astype(f32),
            ((spk >> 8) & 255).astype(f32),
            ((spk >> 16) & 255).astype(f32),
            selev,
            ((spk >> 24) & 1).astype(f32),
            ((spk >> 25) & 1).astype(f32),
            ((spk >> 26) & 1).astype(f32),
            ((spk >> 27) & 1).astype(f32),
        ], axis=0)
        return _accumulate_sorted(sidx, sdata, n_bins, f32)
    return _bin_sum_sorted(flat_idx, weights, data, n_bins, n_ch)


# ---------------------------------------------------------------------------
# one-hot-matmul binning in batched XLA matmuls (bf16 one-hots are exact for
# 0/1 and 0..255 integer imagery); kept for comparison with the GPU route
# ---------------------------------------------------------------------------

_TILE_H = 16
_TILE_W = 128
_WIN_R = 16
_ELEV_OFFSET = 90.0


def _split_elev_channel(data):
    el = data[..., -1] + _ELEV_OFFSET
    hi = jnp.floor(el)
    return jnp.concatenate([data[..., :-1], hi[..., None], (el - hi)[..., None]],
                           axis=-1)


def _n_frac_channels(mode, n_ch_in, n_ch):
    """Channels of the split layout that are NOT bf16-exact (the fractional
    limbs; every mode keeps them LAST): 'uint8' has one trailing elevation
    fraction, 'full' has a trailing base-256 fraction per input channel,
    any other mode passes raw floats through unsplit."""
    if mode == "uint8":
        return 1
    if mode == "full":
        return n_ch_in
    return n_ch


def _split_digits(data):
    hi = jnp.floor(data / 256.0)
    rem = data - 256.0 * hi
    mid = jnp.floor(rem)
    return jnp.concatenate([hi, mid, rem - mid], axis=-1)


_WTILE = 64  # square pixel tile for the window method
_WWIN_R = 8
_WWIN_C = 16


@partial(jax.jit, static_argnums=(0, 4))
def bin_partial_window(grid: GridSpec, lats, lons, data, mode="uint8"):
    """Partial (count, sums) via small-window one-hot matmuls + block scatter.

    64x64-pixel tiles land in a tight (rows x cols) window of grid cells
    (interior tiles span ~4x3 cells); each tile's pixels one-hot into the
    flattened 8x16-cell window (one bf16 matmul per tile, batched), and the
    ~3k resulting window blocks scatter-add into the grid — 3k block updates
    instead of 12M element updates. The one-hot is only 128 wide, so its HBM
    traffic is ~3 GB instead of the 12 GB a full-row window costs.

    Out-of-window pixels (horizon) spill to the exact sorted path.
    """
    h, w = lats.shape
    n_ch_in = data.shape[-1]
    f32 = jnp.float32
    # bin indices BEFORE any f32 cast, with bin_indices' exact arithmetic
    # (division, input dtype) — a mul-by-reciprocal in f32 flips pixels
    # sitting on cell edges into the neighbouring cell vs the sorted path
    flat_full, valid_full = bin_indices(grid, lats, lons)
    iy_full = (flat_full // grid.n_lon).astype(jnp.int32)
    ix_full = (flat_full % grid.n_lon).astype(jnp.int32)
    data = data.astype(f32)
    data = jnp.where(valid_full.reshape(h, w)[..., None], data, 0.0)
    if mode == "uint8":
        data_k = _split_elev_channel(data)
    elif mode == "full":
        data_k = _split_digits(data)
    else:
        data_k = data
    n_ch = data_k.shape[-1]
    n_stack = n_ch + 1

    t = _WTILE
    hp = round_up(h, t)
    wp = round_up(w, t)
    iy_p = jnp.pad(iy_full.reshape(h, w), ((0, hp - h), (0, wp - w)),
                   constant_values=-1)
    ix_p = jnp.pad(ix_full.reshape(h, w), ((0, hp - h), (0, wp - w)),
                   constant_values=-1)
    valid_p = jnp.pad(valid_full.reshape(h, w), ((0, hp - h), (0, wp - w)))
    data_k = jnp.pad(data_k, ((0, hp - h), (0, wp - w), (0, 0)))

    def tiles(a):
        if a.ndim == 2:
            return a.reshape(hp // t, t, wp // t, t).transpose(0, 2, 1, 3) \
                    .reshape(-1, t * t)
        c = a.shape[-1]
        return a.reshape(hp // t, t, wp // t, t, c).transpose(0, 2, 1, 3, 4) \
                .reshape(-1, t * t, c)

    iy, ix, valid, d_t = tiles(iy_p), tiles(ix_p), tiles(valid_p), tiles(data_k)
    n_tiles, p = iy.shape

    big = jnp.int32(1 << 30)
    r0 = jnp.clip(jnp.min(jnp.where(valid, iy, big), axis=1), 0, grid.n_lat - 1)
    c0 = jnp.clip(jnp.min(jnp.where(valid, ix, big), axis=1), 0, grid.n_lon - 1)
    dr = iy - r0[:, None]
    dc = ix - c0[:, None]
    in_win = valid & (dr < _WWIN_R) & (dc < _WWIN_C)
    loc = jnp.where(in_win, dr * _WWIN_C + dc, -1)

    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (n_tiles, p, _WWIN_R * _WWIN_C), 2)
        == loc[:, :, None]
    ).astype(jnp.bfloat16)
    ones = jnp.ones((n_tiles, 1, p), f32)
    d_all = jnp.concatenate([ones, d_t.transpose(0, 2, 1)], axis=1)  # (B, n_stack, P)
    # bf16-exact channels (count + integer imagery/limbs) ride the fast
    # bf16 dot; the trailing FRACTIONAL limbs would be truncated by a
    # bf16 cast (measured: up to 0.01 on per-bin elevation sums), so they
    # take a separate f32 HIGHEST dot — this is the XLA fallback path,
    # exactness beats speed here
    n_frac = _n_frac_channels(mode, n_ch_in, n_ch)
    n_exact = n_stack - n_frac
    dn = (((2,), (1,)), ((0,), (0,)))
    s_e = jax.lax.dot_general(
        d_all[:, :n_exact].astype(jnp.bfloat16), onehot,
        dimension_numbers=dn, preferred_element_type=f32,
    )
    s_f = jax.lax.dot_general(
        d_all[:, n_exact:], onehot.astype(f32),
        dimension_numbers=dn, preferred_element_type=f32,
        precision=jax.lax.Precision.HIGHEST,
    )
    s = jnp.concatenate([s_e, s_f], axis=1)  # (B, n_stack, WR*WC)
    updates = s.reshape(n_tiles, n_stack, _WWIN_R, _WWIN_C)

    acc = jnp.zeros((n_stack, grid.n_lat + _WWIN_R, grid.n_lon + _WWIN_C), f32)
    idx = jnp.stack([jnp.zeros_like(r0), r0, c0], axis=-1)  # (B, 3)
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2, 3),
        inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1, 2),
    )
    acc = jax.lax.scatter_add(
        acc, idx, updates, dnums,
        indices_are_sorted=False, unique_indices=False,
    )
    count = acc[0, : grid.n_lat, : grid.n_lon]
    sums_k = jnp.transpose(acc[1:, : grid.n_lat, : grid.n_lon], (1, 2, 0))

    spill = jnp.where(valid & ~in_win, iy * grid.n_lon + ix,
                      grid.n_lat * grid.n_lon).reshape(-1)
    acc2 = _bin_sum_sorted(spill, None, d_t.reshape(-1, n_ch),
                           grid.n_lat * grid.n_lon, n_ch)
    count = count + acc2[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums_k = sums_k + acc2[:, 1:].reshape(grid.n_lat, grid.n_lon, n_ch)

    if mode == "uint8":
        # subtract the offset from the integer-limb sum FIRST: both are
        # exact f32 integers (< 2^24), so the fraction sum is added at its
        # own small magnitude instead of rounding at ~offset*count
        el = (sums_k[..., -2] - _ELEV_OFFSET * count) + sums_k[..., -1]
        sums = jnp.concatenate([sums_k[..., : n_ch_in - 1], el[..., None]],
                               axis=-1)
    elif mode == "full":
        sums = (256.0 * sums_k[..., :n_ch_in]
                + sums_k[..., n_ch_in : 2 * n_ch_in]
                + sums_k[..., 2 * n_ch_in :])
    else:
        sums = sums_k
    return count, sums


@partial(jax.jit, static_argnums=(0, 4))
def bin_partial_tiled(grid: GridSpec, lats, lons, data, mode="uint8"):
    """Partial (count, sums) via tile-local separable one-hot matmuls.

    Image-space tiles land in a narrow, 8-aligned band of grid rows;
    per tile, channel-stacked row one-hots (M = channels x 16 rows) multiply
    the column one-hot in one matmul, tiles reduce into 8-aligned row groups by
    a second matmul, and the ~60 groups overlap-add into the grid — no
    scatter, no sort on the hot path. bf16 one-hots are exact for 0/1 and
    0..255 integer imagery ('uint8' mode splits the trailing elevation
    channel into int+frac; 'full' mode base-256-splits every channel).
    Counts and integer-channel sums are bit-exact vs the sorted path; the
    FRACTIONAL limbs ride a separate f32 HIGHEST dot (a bf16 cast of them
    cost up to 1e-2 per bin) so elevation sums are f32-accumulation
    accurate — tighter than the sorted path's in-chunk f32 prefixes.

    Out-of-window pixels (near the horizon the pixel footprint outgrows the
    row band) spill to the exact sorted path. NOTE: the spill sort is NOT
    cheap — "adaptive sort" does not apply to payload sorts (an
    all-sentinel 12M-key sort still pays full payload passes).
    """
    h, w = lats.shape
    n_ch_in = data.shape[-1]
    f32 = jnp.float32
    # index with bin_indices' exact arithmetic BEFORE any f32 cast so edge
    # pixels land in the same cell as the sorted path (see bin_partial_window)
    flat_full, valid_full = bin_indices(grid, lats, lons)
    iy_full = (flat_full // grid.n_lon).astype(jnp.int32).reshape(h, w)
    ix_full = (flat_full % grid.n_lon).astype(jnp.int32).reshape(h, w)
    data = data.astype(f32)
    data = jnp.where(valid_full.reshape(h, w)[..., None], data, 0.0)
    if mode == "uint8":
        data_k = _split_elev_channel(data)
    elif mode == "full":
        data_k = _split_digits(data)
    else:
        data_k = data
    n_ch = data_k.shape[-1]
    n_stack = n_ch + 1

    hp = round_up(h, _TILE_H)
    wp = round_up(w, _TILE_W)
    iy_p = jnp.pad(iy_full, ((0, hp - h), (0, wp - w)), constant_values=-1)
    ix_p = jnp.pad(ix_full, ((0, hp - h), (0, wp - w)), constant_values=-1)
    valid_p = jnp.pad(valid_full.reshape(h, w), ((0, hp - h), (0, wp - w)))
    data_k = jnp.pad(data_k, ((0, hp - h), (0, wp - w), (0, 0)))
    n_lat_pad = max(round_up(grid.n_lat, 8), _WIN_R)
    n_lon_pad = round_up(grid.n_lon, 128)

    def tiles(a):
        if a.ndim == 2:
            return a.reshape(hp // _TILE_H, _TILE_H, wp // _TILE_W, _TILE_W) \
                    .transpose(0, 2, 1, 3).reshape(-1, _TILE_H * _TILE_W)
        c = a.shape[-1]
        return a.reshape(hp // _TILE_H, _TILE_H, wp // _TILE_W, _TILE_W, c) \
                .transpose(0, 2, 1, 3, 4).reshape(-1, _TILE_H * _TILE_W, c)

    iy = tiles(iy_p)  # (B, P)
    ix = tiles(ix_p)
    valid = tiles(valid_p)
    d_t = tiles(data_k)  # (B, P, n_ch)
    n_tiles, p = iy.shape

    big = jnp.int32(1 << 30)
    r0 = jnp.min(jnp.where(valid, iy, big), axis=1)  # (B,)
    r0 = jnp.clip((r0 // 8) * 8, 0, n_lat_pad - _WIN_R)
    dr = iy - r0[:, None]
    in_win = valid & (dr >= 0) & (dr < _WIN_R)

    dr_h = jnp.where(in_win, dr, -1)
    dc_h = jnp.where(in_win, ix, -1)

    n_groups = (n_lat_pad - _WIN_R) // 8 + 1
    group = r0 // 8  # (B,)

    # channels are blocked as rows [c*WIN_R, (c+1)*WIN_R) of `a`; the
    # trailing FRACTIONAL limb channels are not bf16-exact, so they take a
    # separate f32 HIGHEST dot (see bin_partial_window)
    n_frac = _n_frac_channels(mode, n_ch_in, n_ch)
    n_exact = n_stack - n_frac

    def chunk_fn(args):
        dr_c, dc_c, d_c = args  # (CB, P), (CB, P), (CB, P, n_ch)
        cb = dr_c.shape[0]
        ey = (jax.lax.broadcasted_iota(jnp.int32, (cb, _WIN_R, p), 1)
              == dr_c[:, None, :])
        ex = (jax.lax.broadcasted_iota(jnp.int32, (cb, p, n_lon_pad), 2)
              == dc_c[:, :, None]).astype(jnp.bfloat16)
        ones = jnp.ones((cb, p, 1), f32)
        d_all = jnp.concatenate([ones, d_c], axis=-1)  # (CB, P, n_stack)
        a = (ey[:, None, :, :] * d_all.transpose(0, 2, 1)[:, :, None, :]).reshape(
            cb, n_stack * _WIN_R, p
        )
        dn = (((2,), (1,)), ((0,), (0,)))
        s_e = jax.lax.dot_general(
            a[:, : n_exact * _WIN_R].astype(jnp.bfloat16), ex,
            dimension_numbers=dn, preferred_element_type=f32,
        )
        s_f = jax.lax.dot_general(
            a[:, n_exact * _WIN_R :], ex.astype(f32),
            dimension_numbers=dn, preferred_element_type=f32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.concatenate([s_e, s_f], axis=1)
        # (CB, n_stack*WIN_R, n_lon_pad)

    chunk = 128
    n_tiles_pad = round_up(n_tiles, chunk)
    pad_b = n_tiles_pad - n_tiles
    dr_p = jnp.pad(dr_h, ((0, pad_b), (0, 0)), constant_values=-1)
    dc_p = jnp.pad(dc_h, ((0, pad_b), (0, 0)), constant_values=-1)
    dd_p = jnp.pad(d_t, ((0, pad_b), (0, 0), (0, 0)))
    s = jax.lax.map(
        chunk_fn,
        (dr_p.reshape(-1, chunk, p), dc_p.reshape(-1, chunk, p),
         dd_p.reshape(-1, chunk, p, n_ch)),
    ).reshape(n_tiles_pad, n_stack * _WIN_R, n_lon_pad)[:n_tiles]

    # reduce tiles into their 8-aligned row groups with one f32 matmul
    g_onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (n_groups, n_tiles), 0)
        == group[None, :]
    ).astype(f32)
    grouped = jax.lax.dot_general(
        g_onehot, s.reshape(n_tiles, -1),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=f32,
        # an f32 x f32 dot may run in reduced precision at DEFAULT,
        # which would round the accumulated sums; the one-hot side is
        # exact so HIGHEST restores exactness
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(n_groups, n_stack, _WIN_R, n_lon_pad)

    acc = jnp.zeros((n_stack, n_lat_pad + _WIN_R, n_lon_pad), f32)
    for g in range(n_groups):  # static unroll: ~60 shifted adds
        acc = acc.at[:, g * 8 : g * 8 + _WIN_R, :].add(grouped[g])
    count = acc[0, : grid.n_lat, : grid.n_lon]
    sums_k = jnp.transpose(acc[1:, : grid.n_lat, : grid.n_lon], (1, 2, 0))

    # spill pass (exact) via the sorted path
    spill = jnp.where(valid & ~in_win, iy * grid.n_lon + ix,
                      grid.n_lat * grid.n_lon).reshape(-1)
    acc2 = _bin_sum_sorted(spill, None, d_t.reshape(-1, n_ch),
                           grid.n_lat * grid.n_lon, n_ch)
    count = count + acc2[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums_k = sums_k + acc2[:, 1:].reshape(grid.n_lat, grid.n_lon, n_ch)

    if mode == "uint8":
        # subtract the offset from the integer-limb sum FIRST: both are
        # exact f32 integers (< 2^24), so the fraction sum is added at its
        # own small magnitude instead of rounding at ~offset*count
        el = (sums_k[..., -2] - _ELEV_OFFSET * count) + sums_k[..., -1]
        sums = jnp.concatenate([sums_k[..., : n_ch_in - 1], el[..., None]],
                               axis=-1)
    elif mode == "full":
        sums = (256.0 * sums_k[..., :n_ch_in]
                + sums_k[..., n_ch_in : 2 * n_ch_in]
                + sums_k[..., 2 * n_ch_in :])
    else:
        sums = sums_k
    return count, sums


@partial(jax.jit, static_argnums=(3, 4))
def _bin_sum_scatter(flat_idx, weights, data, n_bins, n_ch):
    vals = jnp.concatenate([weights[:, None], data], axis=1)
    acc = jnp.zeros((n_bins + 1, n_ch + 1), dtype=data.dtype)
    return acc.at[flat_idx].add(vals)[:-1]


def bin_indices(grid: GridSpec, lats, lons):
    """Flat bin index per sample; out-of-range/NaN -> n_bins (dump slot).

    Bin edges are centre +- step/2, matching the reference's histogram2d
    ranges (resample.py:330-338). Following numpy histogram semantics the
    right-most edge is inclusive.
    """
    lat_hi_edge = grid.lat0 + grid.lat_step / 2
    lon_lo_edge = grid.lon0 - grid.lon_step / 2
    fy = (lat_hi_edge - lats) / grid.lat_step
    fx = (lons - lon_lo_edge) / grid.lon_step
    iy = jnp.floor(fy).astype(jnp.int32)
    ix = jnp.floor(fx).astype(jnp.int32)
    # inclusive right-most edge: clamp samples exactly on the far edge
    iy = jnp.where((fy == grid.n_lat) & (iy == grid.n_lat), grid.n_lat - 1, iy)
    ix = jnp.where((fx == grid.n_lon) & (ix == grid.n_lon), grid.n_lon - 1, ix)
    valid = (iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon)
    valid &= jnp.isfinite(lats) & jnp.isfinite(lons)
    flat = jnp.where(valid, iy * grid.n_lon + ix, grid.n_lat * grid.n_lon)
    return flat, valid


_BIN_METHODS = {
    "segment": _bin_sum_segment,
    "scatter": _bin_sum_scatter,
    "sorted": _bin_sum_sorted,
    "sorted_gather": _bin_sum_sorted_gather,
    "sorted_packed": _bin_sum_sorted_packed,
}


@partial(jax.jit, static_argnums=(0, 4))
def bin_mean(grid: GridSpec, lats, lons, data, method="sorted"):
    """Mean-bin multi-channel samples onto the grid.

    :param lats, lons: sample coordinates (any shape), NaN = masked
    :param data: (..., C) channel values per sample. NaN data at VALID
        coordinates taints its bin's mean in that channel only — numpy
        bincount/histogram2d semantics, which the reference relies on
        (it bins img+elevation filled with NaN). NaNs are zeroed and
        binned alongside per-channel taint indicator channels: a raw NaN
        riding the sorted path's prefix sums would leak into every bin
        AFTER it in sort order, not just its own.
    :returns: (count (n_lat, n_lon), means (n_lat, n_lon, C)); means are NaN
        where count == 0
    """
    n_ch = data.shape[-1]
    flat_lats = jnp.ravel(lats)
    flat_lons = jnp.ravel(lons)
    flat_data = jnp.reshape(data, (-1, n_ch))
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    weights = valid.astype(jnp.float32)
    # zero out data of invalid samples so the dump slot stays finite
    flat_data = jnp.where(valid[:, None], flat_data, 0.0)
    taint = jnp.isnan(flat_data)
    flat_data = jnp.concatenate(
        [jnp.where(taint, 0.0, flat_data), taint.astype(flat_data.dtype)],
        axis=1,
    )
    n_bins = grid.n_lat * grid.n_lon
    fn = _BIN_METHODS[method]
    kw = {"layout": "taint"} if method == "sorted_packed" else {}
    acc = fn(flat_idx, weights, flat_data, n_bins, 2 * n_ch, **kw)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1 : 1 + n_ch].reshape(grid.n_lat, grid.n_lon, n_ch)
    taints = acc[:, 1 + n_ch :].reshape(grid.n_lat, grid.n_lon, n_ch)
    means = jnp.where(count[..., None] > 0, sums / count[..., None], jnp.nan)
    means = jnp.where(taints > 0, jnp.nan, means)
    return count, means


@partial(jax.jit, static_argnums=(0, 4))
def bin_partial(grid: GridSpec, lats, lons, data, method="segment"):
    """Per-shard partial accumulation: (count, sums) WITHOUT the divide.

    Used by the sharded mosaic path: shards accumulate locally, a psum /
    reduce-scatter combines (count, sums) across the mesh, and the divide
    happens once after the reduction (SURVEY.md P6).

    NaN DATA at valid coordinates is treated as 0 here (partial sums must
    stay finite for the cross-shard reduction; a raw NaN riding the
    sorted path's prefix sums would corrupt every later bin). Use
    :func:`bin_mean` for the reference's NaN-taint semantics.
    """
    n_ch = data.shape[-1]
    flat_lats = jnp.ravel(lats)
    flat_lons = jnp.ravel(lons)
    flat_data = jnp.reshape(data, (-1, n_ch))
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    weights = valid.astype(flat_data.dtype)
    flat_data = jnp.where(valid[:, None], flat_data, 0.0)
    flat_data = jnp.where(jnp.isnan(flat_data), 0.0, flat_data)
    n_bins = grid.n_lat * grid.n_lon
    fn = _BIN_METHODS[method]
    acc = fn(flat_idx, weights, flat_data, n_bins, n_ch)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1:].reshape(grid.n_lat, grid.n_lon, n_ch)
    return count, sums


def finalize_mean(count, sums):
    """Divide reduced partial sums by counts; NaN where empty."""
    return jnp.where(count[..., None] > 0, sums / count[..., None], jnp.nan)


@partial(jax.jit, static_argnums=(0, 4))
def bin_nearest(grid: GridSpec, lats, lons, data, oversample=2):
    """Nearest-SAMPLE resampling on device (scipy.griddata('nearest')
    semantics: every grid cell takes the value of the closest sample point
    in lat/lon degree space).

    The reference recommends 'nearest' over 'mean' for grids finer than the
    native pixel scale (reference resample.py:323-329) but reaches it
    through host scipy (a KD-tree). Here it is two device phases:

    1. **seed**: a two-key ``lax.sort`` by (bin, distance-to-cell-centre)
       makes each occupied cell's nearest LOCAL sample the first entry of
       its bin range (range starts via the same vectorized binary search as
       the sorted mean path);
    2. **jump-flood** (JFA): log2(grid) rounds of 8-neighbour shifted
       min-distance propagation of (seed_lat, seed_lon, payload) planes —
       dense elementwise work that XLA fuses, no scatter/gather.

    Approximation: only the best sample per SEED cell survives seeding, so
    a discarded co-binned sample that is the true winner of a *neighbouring*
    cell is lost; ``oversample`` runs seeding+JFA on an s-times finer grid
    (cost x s^2) and reads the coarse centres off it, shrinking multi-
    sample seed cells. Measured vs scipy on clustered random samples
    (~0.33/cell Poisson): s=1 91.4%% of cells bit-equal, s=2 97.6%%,
    s=4 99.3%% — every miss still holds a *nearby* real sample. Grids finer
    than the sample spacing (the method's intended regime) have almost no
    multi-sample cells and match correspondingly closer.

    Outside-footprint cells still get a nearest sample propagated by the
    JFA (scipy-like semantics); callers mask by outline exactly as the
    reference does (resample.py:250-259). Border caveat: samples falling
    OUTSIDE the grid coverage are dropped by ``bin_indices`` before
    seeding (the oversample pad ring only recovers ~(pad/s) cells beyond
    the edge), so a border cell whose true nearest sample lies outside the
    grid can take a farther in-grid sample than scipy's global KD-tree
    would — one more way a miss still holds a nearby real sample, not
    exactness at the border.

    :returns: (data_grid (n_lat, n_lon, C), dist2_grid (n_lat, n_lon) —
        squared degree distance to the winning sample; +inf when there are
        no valid samples at all)
    """
    s_over = int(oversample)
    if s_over > 1:
        # fine grid whose centre (pad + i*s, pad + j*s) coincides with
        # coarse centre (i, j); seeding + JFA run fine, the coarse result
        # is a strided slice. ``pad`` extra fine cells per border keep the
        # fine COVERAGE a superset of the coarse cell edges — without it
        # the fine edges sit step/(2s) beyond the outer centres vs the
        # coarse step/2, silently dropping every sample in that boundary
        # ring (a border cell would then take a far-away winner).
        pad = s_over  # >= ceil((s-1)/2); covers slightly beyond coarse
        fine = GridSpec(
            n_lat=(grid.n_lat - 1) * s_over + 1 + 2 * pad,
            n_lon=(grid.n_lon - 1) * s_over + 1 + 2 * pad,
            lat0=grid.lat0 + pad * grid.lat_step / s_over,
            lon0=grid.lon0 - pad * grid.lon_step / s_over,
            lat_step=grid.lat_step / s_over,
            lon_step=grid.lon_step / s_over,
        )
        dg, d2g = bin_nearest(fine, lats, lons, data, oversample=1)
        sl_lat = slice(pad, pad + (grid.n_lat - 1) * s_over + 1, s_over)
        sl_lon = slice(pad, pad + (grid.n_lon - 1) * s_over + 1, s_over)
        return dg[sl_lat, sl_lon], d2g[sl_lat, sl_lon]
    n_ch = data.shape[-1]
    f32 = jnp.float32
    flat_lats = jnp.ravel(lats).astype(f32)
    flat_lons = jnp.ravel(lons).astype(f32)
    flat_data = jnp.reshape(data, (-1, n_ch)).astype(f32)
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    n_bins = grid.n_lat * grid.n_lon

    lat_c = jnp.asarray(grid.lat_centers, f32)
    lon_c = jnp.asarray(grid.lon_centers, f32)
    iy = jnp.clip(flat_idx // grid.n_lon, 0, grid.n_lat - 1)
    ix = jnp.clip(flat_idx % grid.n_lon, 0, grid.n_lon - 1)
    d2 = (flat_lats - lat_c[iy]) ** 2 + (flat_lons - lon_c[ix]) ** 2
    key = jnp.where(valid, flat_idx, n_bins).astype(jnp.int32)
    d2 = jnp.where(valid, d2, jnp.inf)
    la = jnp.where(valid, flat_lats, 0.0)
    lo = jnp.where(valid, flat_lons, 0.0)
    # NaN payload stays NaN: a NaN-masked sample that wins a cell yields a
    # NaN cell, exactly like the scipy path (which filters only NaN
    # coordinates). Invalid-coordinate samples never win (key == n_bins),
    # so their payload value is irrelevant — zeroed to keep sorts NaN-free.
    pay = jnp.where(valid[:, None], flat_data, 0.0)
    ops = [key, d2.astype(f32), la, lo] + [pay[:, c] for c in range(n_ch)]
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    skey = sorted_ops[0]

    bins_ext = jnp.arange(n_bins + 1, dtype=jnp.int32)
    starts_ext = _searchsorted_binary(skey, bins_ext, side="left")
    starts, ends = starts_ext[:-1], starts_ext[1:]
    occupied = ends > starts
    at = jnp.minimum(starts, skey.shape[0] - 1)

    def seed(plane, fill):
        return jnp.where(occupied, plane[at], fill).reshape(
            grid.n_lat, grid.n_lon)

    seed_lat = seed(sorted_ops[2], 0.0)
    seed_lon = seed(sorted_ops[3], 0.0)
    planes = jnp.stack([seed(sorted_ops[4 + c], 0.0) for c in range(n_ch)],
                       axis=0)

    cy = lat_c[:, None]
    cx = lon_c[None, :]
    best = jnp.where(occupied.reshape(grid.n_lat, grid.n_lon),
                     (seed_lat - cy) ** 2 + (seed_lon - cx) ** 2, jnp.inf)

    n = max(grid.n_lat, grid.n_lon)
    steps = []
    s = 1 << max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # extra unit pass cleans up classic JFA misses

    state = jnp.concatenate([seed_lat[None], seed_lon[None], planes], axis=0)
    for s in steps:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                pad = ((0, 0), (abs(dy), abs(dy)), (abs(dx), abs(dx)))
                stp = jnp.pad(state, pad)
                stp = stp[:, abs(dy) - dy : abs(dy) - dy + grid.n_lat,
                          abs(dx) - dx : abs(dx) - dx + grid.n_lon]
                bp = jnp.pad(best, pad[1:], constant_values=jnp.inf)
                bp = bp[abs(dy) - dy : abs(dy) - dy + grid.n_lat,
                        abs(dx) - dx : abs(dx) - dx + grid.n_lon]
                cand_d = jnp.where(
                    jnp.isinf(bp), jnp.inf,
                    (stp[0] - cy) ** 2 + (stp[1] - cx) ** 2)
                take = cand_d < best
                best = jnp.where(take, cand_d, best)
                state = jnp.where(take[None], stp, state)

    return jnp.moveaxis(state[2:], 0, -1), best


@partial(jax.jit, static_argnums=(0,))
def bin_take_best(grid: GridSpec, lats, lons, priority, data):
    """Per-cell winner selection: each occupied grid cell takes the payload
    of its sample with the SMALLEST priority value.

    The device form of the reference's elevation-sorted overlap priority
    for multi-ASI collections (reference draw_helpers.py:128-178 sorts the
    polygon collections so the station viewing a spot closest to zenith
    draws last): pass ``priority=-elevation`` and bin the samples of ALL
    stations in one call — each cell keeps the highest-elevation station's
    pixel. One two-key ``lax.sort`` + the vectorized binary-search bin
    starts of the sorted mean path; no scatter.

    Semantics: NaN-coordinate samples never win. NaN *priority* at valid
    coordinates sorts last (jax total order), so such a sample wins only
    when its cell has no finite-priority competitor. A winning sample's
    NaN payload channel stays NaN.

    :param priority: per-sample sort key, same shape as ``lats``
    :param data: (..., C) payload channels per sample
    :returns: (data_grid (n_lat, n_lon, C) — NaN where empty,
               best_priority (n_lat, n_lon) — +inf where empty)
    """
    n_ch = data.shape[-1]
    f32 = jnp.float32
    flat_lats = jnp.ravel(lats).astype(f32)
    flat_lons = jnp.ravel(lons).astype(f32)
    flat_pri = jnp.ravel(priority).astype(f32)
    flat_data = jnp.reshape(data, (-1, n_ch)).astype(f32)
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    n_bins = grid.n_lat * grid.n_lon

    key = jnp.where(valid, flat_idx, n_bins).astype(jnp.int32)
    pri = jnp.where(valid, flat_pri, jnp.inf)
    # invalid samples never win (key == n_bins) — zero their payload so
    # the dump slot stays NaN-free in the sort
    pay = jnp.where(valid[:, None], flat_data, 0.0)
    ops = [key, pri] + [pay[:, c] for c in range(n_ch)]
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    skey = sorted_ops[0]

    bins_ext = jnp.arange(n_bins + 1, dtype=jnp.int32)
    starts_ext = _searchsorted_binary(skey, bins_ext, side="left")
    starts, ends = starts_ext[:-1], starts_ext[1:]
    occupied = (ends > starts).reshape(grid.n_lat, grid.n_lon)
    at = jnp.minimum(starts, skey.shape[0] - 1)

    planes = [
        jnp.where(occupied, sorted_ops[2 + c][at].reshape(
            grid.n_lat, grid.n_lon), jnp.nan)
        for c in range(n_ch)
    ]
    best = jnp.where(occupied, sorted_ops[1][at].reshape(
        grid.n_lat, grid.n_lon), jnp.inf)
    return jnp.stack(planes, axis=-1), best


@jax.tree_util.register_pytree_node_class
class TakeBestPlan:
    """:func:`plan_take_best` result. Registered as a pytree whose
    ``n_samples`` rides in the STATIC treedef (not as a leaf), so the
    sample-count validation in :func:`apply_take_best` stays alive even
    when the plan is passed through a ``jax.jit`` boundary — a plain
    tuple leaf would turn into a tracer there and silently disable the
    check (jax's clamped gather would then composite wrong samples
    without error). Unpacks like the historical 4-tuple."""

    def __init__(self, winner, occupied, best_priority, n_samples):
        self.winner = winner
        self.occupied = occupied
        self.best_priority = best_priority
        self.n_samples = int(n_samples)

    def __iter__(self):
        return iter((self.winner, self.occupied, self.best_priority,
                     self.n_samples))

    def __getitem__(self, i):
        return (self.winner, self.occupied, self.best_priority,
                self.n_samples)[i]

    def tree_flatten(self):
        return ((self.winner, self.occupied, self.best_priority),
                self.n_samples)

    @classmethod
    def tree_unflatten(cls, n_samples, children):
        return cls(*children, n_samples)


def plan_take_best(grid: GridSpec, lats, lons, priority):
    """Precompute the per-cell winning SAMPLE for a static geometry.

    ASI deployments composite every exposure (THEMIS: one per 3 s) with
    the SAME station calibration grids — coordinates and elevation
    priorities are static per night, only imagery changes.
    :func:`bin_take_best` re-sorts all samples with full payloads every
    call; this planner runs the two-key sort ONCE and returns a plan
    (winning flat sample index per cell + occupancy + winning priority);
    :func:`apply_take_best` then composites an exposure with a single
    gather. Output is bit-identical to bin_take_best (same stable
    two-key sort decides the winner).

    :returns: :class:`TakeBestPlan` (winner (n_lat*n_lon,) int32,
               occupied (n_lat, n_lon) bool, best_priority (n_lat, n_lon)
               — +inf where empty, n_samples python int — the planned
               sample count, static so :func:`apply_take_best` validates
               exposures against it even under jit)
    """
    f32 = jnp.float32
    flat_lats = jnp.ravel(lats).astype(f32)
    flat_lons = jnp.ravel(lons).astype(f32)
    flat_pri = jnp.ravel(priority).astype(f32)
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    n_bins = grid.n_lat * grid.n_lon

    key = jnp.where(valid, flat_idx, n_bins).astype(jnp.int32)
    pri = jnp.where(valid, flat_pri, jnp.inf)
    sidx = jnp.arange(key.shape[0], dtype=jnp.int32)
    skey, spri, ssidx = jax.lax.sort([key, pri, sidx], num_keys=2)

    bins_ext = jnp.arange(n_bins + 1, dtype=jnp.int32)
    starts_ext = _searchsorted_binary(skey, bins_ext, side="left")
    starts, ends = starts_ext[:-1], starts_ext[1:]
    occupied = (ends > starts).reshape(grid.n_lat, grid.n_lon)
    at = jnp.minimum(starts, skey.shape[0] - 1)
    winner = ssidx[at]
    best = jnp.where(occupied, spri[at].reshape(grid.n_lat, grid.n_lon),
                     jnp.inf)
    return TakeBestPlan(winner, occupied, best, key.shape[0])


def apply_take_best(plan, data):
    """Composite one exposure's payloads with a :func:`plan_take_best`
    plan: ONE gather instead of a full payload sort. ``data`` must have
    the same sample layout (...) x C as the planner's coordinate arrays —
    validated against the plan's sample count at trace time (jax's
    clamped gather would otherwise return silently WRONG composites for
    a cropped/re-binned exposure). A winning sample's NaN payload channel
    stays NaN; empty cells are NaN (same semantics as bin_take_best)."""
    winner, occupied, _, n_samples = plan
    n_ch = data.shape[-1]
    flat = jnp.reshape(data, (-1, n_ch)).astype(jnp.float32)
    # TakeBestPlan carries n_samples statically, so this check is live
    # even when the plan crosses a jit boundary. Legacy 4-tuple plans
    # with an ARRAY count degrade to a skipped check only if that leaf
    # was traced.
    expected = (None if isinstance(n_samples, jax.core.Tracer)
                else int(n_samples))
    if expected is not None and flat.shape[0] != expected:
        raise ValueError(
            f"exposure has {flat.shape[0]} samples but the plan was built "
            f"for {expected} — re-plan for this geometry (a clamped "
            "gather would composite the wrong samples silently)")
    vals = flat[winner].reshape(occupied.shape + (n_ch,))
    return jnp.where(occupied[..., None], vals, jnp.nan)


def _patch_bilinear(field, y0, x0, fy, fx):
    """Bilinear patch value + analytic in-patch derivatives at (fy, fx)."""
    f00 = field[y0, x0]
    f01 = field[y0, x0 + 1]
    f10 = field[y0 + 1, x0]
    f11 = field[y0 + 1, x0 + 1]
    val = ((1 - fy) * ((1 - fx) * f00 + fx * f01)
           + fy * ((1 - fx) * f10 + fx * f11))
    ddx = (1 - fy) * (f01 - f00) + fy * (f11 - f10)
    ddy = (1 - fx) * (f10 - f00) + fx * (f11 - f01)
    return val, ddx, ddy


def _invert_mesh(grid: GridSpec, lat_src, lon_src, n_iter):
    """Fractional source position of every target cell centre on the
    smooth (h, w) lat/lon mesh: jump-flood nearest seeding + Newton on the
    bilinear patch map. Returns (yc, xc, y0, x0, fy, fx, ok) — clamped
    positions, their patch index/fraction decomposition, and the
    converged-and-in-footprint predicate. Shared by the linear and cubic
    device interpolators."""
    h, w = lat_src.shape
    dtype = lat_src.dtype

    rows = jnp.broadcast_to(jnp.arange(h, dtype=dtype)[:, None], (h, w))
    cols = jnp.broadcast_to(jnp.arange(w, dtype=dtype)[None, :], (h, w))
    seed, _ = bin_nearest(grid, lat_src, lon_src,
                          jnp.stack([rows, cols], axis=-1), oversample=1)
    y = jnp.asarray(seed[..., 0], dtype)
    x = jnp.asarray(seed[..., 1], dtype)

    tgt_lat = jnp.asarray(grid.lat_centers, dtype)[:, None]
    tgt_lon = jnp.asarray(grid.lon_centers, dtype)[None, :]

    for _ in range(n_iter):
        yc = jnp.clip(y, 0.0, h - 1.0)
        xc = jnp.clip(x, 0.0, w - 1.0)
        y0 = jnp.clip(jnp.floor(yc), 0, h - 2).astype(jnp.int32)
        x0 = jnp.clip(jnp.floor(xc), 0, w - 2).astype(jnp.int32)
        fy = yc - y0
        fx = xc - x0
        la, la_dx, la_dy = _patch_bilinear(lat_src, y0, x0, fy, fx)
        lo, lo_dx, lo_dy = _patch_bilinear(lon_src, y0, x0, fy, fx)
        r_lat = la - tgt_lat
        r_lon = lo - tgt_lon
        det = la_dx * lo_dy - la_dy * lo_dx
        safe = jnp.abs(det) > 1e-30
        det = jnp.where(safe, det, 1.0)
        dx = (r_lat * lo_dy - r_lon * la_dy) / det
        dy = (r_lon * la_dx - r_lat * lo_dx) / det
        dx = jnp.where(safe, dx, jnp.nan)
        dy = jnp.where(safe, dy, jnp.nan)
        x = xc - dx
        y = yc - dy

    # converged & in range?  (cells outside the footprint run to the
    # border clamp and keep a large residual)
    yc = jnp.clip(y, 0.0, h - 1.0)
    xc = jnp.clip(x, 0.0, w - 1.0)
    y0 = jnp.clip(jnp.floor(yc), 0, h - 2).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(xc), 0, w - 2).astype(jnp.int32)
    fy = yc - y0
    fx = xc - x0
    la, _, _ = _patch_bilinear(lat_src, y0, x0, fy, fx)
    lo, _, _ = _patch_bilinear(lon_src, y0, x0, fy, fx)
    cell2 = jnp.asarray(grid.lat_step, dtype) ** 2 + \
        jnp.asarray(grid.lon_step, dtype) ** 2
    ok = ((la - tgt_lat) ** 2 + (lo - tgt_lon) ** 2) < cell2
    ok &= (y == yc) & (x == xc)
    return yc, xc, y0, x0, fy, fx, ok


@partial(jax.jit, static_argnums=(0, 4))
def interp_linear_structured(grid: GridSpec, lat_src, lon_src, data,
                             n_iter=3):
    """Device linear interpolation onto the grid from a STRUCTURED source.

    The reference's 'linear' method triangulates the scattered pixel
    centres with scipy.griddata (reference resample.py:323-326) — a
    host-only Delaunay pass. A mapping's pixel centres are not arbitrary
    scatter though: they form a smooth (h, w) mesh in lat/lon space, so
    linear interpolation is the INVERSE of that mesh map. This solves it
    on the device, with dense elementwise work and small gathers only:

    1. seed each target cell with its nearest source pixel index via the
       jump-flood machinery (:func:`bin_nearest` carrying (row, col)
       payloads);
    2. Newton-invert the bilinear patch map around the seed: 2-3
       iterations of ``p -= J(p)^-1 (latlon(p) - target)`` with the
       analytic patch Jacobian (the mesh is smooth, so convergence is
       immediate);
    3. bilinearly sample the payload channels at the fractional source
       position.

    Semantics vs scipy-linear: bilinear-on-quads instead of
    linear-on-Delaunay-triangles — both reproduce locally-affine fields
    exactly (gated in tests); on non-smooth data (imagery) the two
    weightings differ within each cell's sample neighbourhood. Cells whose
    interpolation quad touches a NaN source coordinate come out NaN (a
    <=1-cell band at the footprint edge; the outline masking applied by
    resample() covers it, like the reference's hull clipping). Cells
    outside the footprint diverge to the border and are likewise masked
    by the caller.

    :param lat_src, lon_src: (h, w) source-mesh coordinates, NaN = masked
    :param data: (h, w, C) payload channels
    :returns: (data_grid (n_lat, n_lon, C), src_pos (n_lat, n_lon, 2)
        fractional (row, col) source position per cell — NaN where
        unsolved)
    """
    h, w = lat_src.shape
    dtype = jnp.asarray(lat_src).dtype
    lat_src = jnp.asarray(lat_src, dtype)
    lon_src = jnp.asarray(lon_src, dtype)
    data = jnp.asarray(data, dtype)
    n_ch = data.shape[-1]

    yc, xc, y0, x0, fy, fx, ok = _invert_mesh(grid, lat_src, lon_src, n_iter)

    outs = []
    for c in range(n_ch):
        val, _, _ = _patch_bilinear(data[..., c], y0, x0, fy, fx)
        outs.append(jnp.where(ok, val, jnp.nan))
    pos = jnp.stack([jnp.where(ok, yc, jnp.nan),
                     jnp.where(ok, xc, jnp.nan)], axis=-1)
    return jnp.stack(outs, axis=-1), pos


@partial(jax.jit, static_argnums=(0, 4))
def interp_cubic_structured(grid: GridSpec, lat_src, lon_src, data,
                            n_iter=3):
    """Device cubic interpolation: same mesh inversion as
    :func:`interp_linear_structured`, sampled with a separable Catmull-Rom
    bicubic kernel (C1 interpolating, like the reference's Clough-Tocher
    'cubic' — reference resample.py:323-326 — but on the structured source
    mesh instead of a host Delaunay triangulation; both overshoot on
    non-smooth data). Cells whose 4x4 stencil would leave the mesh or
    touch a NaN source value come out NaN (a <=2-cell band at the
    footprint edge and around mask holes vs linear's 1 — an edge-clamped
    stencil would silently lose the kernel's linear precision there)."""
    h, w = lat_src.shape
    dtype = jnp.asarray(lat_src).dtype
    lat_src = jnp.asarray(lat_src, dtype)
    lon_src = jnp.asarray(lon_src, dtype)
    data = jnp.asarray(data, dtype)
    n_ch = data.shape[-1]

    yc, xc, y0, x0, fy, fx, ok = _invert_mesh(grid, lat_src, lon_src, n_iter)
    # full un-clamped 4x4 stencil only (see docstring)
    ok &= (y0 >= 1) & (y0 <= h - 3) & (x0 >= 1) & (x0 <= w - 3)

    def cr_weights(t):
        # Catmull-Rom basis for taps at offsets (-1, 0, 1, 2)
        t2 = t * t
        t3 = t2 * t
        return (
            0.5 * (-t3 + 2 * t2 - t),
            0.5 * (3 * t3 - 5 * t2 + 2),
            0.5 * (-3 * t3 + 4 * t2 + t),
            0.5 * (t3 - t2),
        )

    wy = cr_weights(fy)
    wx = cr_weights(fx)
    ys = [jnp.clip(y0 + m - 1, 0, h - 1) for m in range(4)]
    xs = [jnp.clip(x0 + n - 1, 0, w - 1) for n in range(4)]

    outs = []
    for c in range(n_ch):
        f = data[..., c]
        val = 0.0
        for m in range(4):
            row = 0.0
            for n in range(4):
                row = row + wx[n] * f[ys[m], xs[n]]
            val = val + wy[m] * row
        outs.append(jnp.where(ok, val, jnp.nan))
    pos = jnp.stack([jnp.where(ok, yc, jnp.nan),
                     jnp.where(ok, xc, jnp.nan)], axis=-1)
    return jnp.stack(outs, axis=-1), pos
