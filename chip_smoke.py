"""Smoke test of the main path on one GPU: georeference -> regrid -> mosaic.

Drives the system once through the entry points a user calls, at the sizes
users run (the real 4256 x 2832 ISS frame, the 12 MP regional grid, the
0.05 deg global grid, a 24-station ASI composite), with seeded uint8
imagery. Every phase compares the card's result with the repo's own
reference (the executed-reference f64 goldens, the sorted binning oracle,
or the same computation on the CPU) and stops the run on the first
mismatch.

Phases: 0 device check, 1 ``create_mapping`` in float64, 2 the df64 chain,
3 ``resample`` (mean) against the CPU, 4 the fused f32 step, 5
``mosaic_sequence`` onto the regional and the global grid, 6 the take-best
ASI composite against the CPU, 7 generic-projection f32 parity.

``--multichip`` runs only the path users run across cards: the 0.05 deg
global grid with an 8-frame burst through the grid-sharded step on 4 cards
as (dp=4, sp=1) and (dp=2, sp=2), and ``mosaic_sequence`` on 4 cards, each
against the 1-card result of the same process.

Usage::

    python chip_smoke.py [--multichip]

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failure
exits nonzero before it is printed. Times printed per phase are
informative only.
"""

import argparse
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(REPO, "tests", "resources")
FRAME = "ISS030-E-102170_dc"
REGIONAL = ((36, 25), 47.0, 62.0, -112.0, -91.0)  # 540 x 525 cells
GLOBAL = (20, -89.999, 89.999, -179.999, 179.999)  # 3599 x 7199 cells
CARD = ""  # nvidia-smi name + power limit, filled by device_check


class ParityError(AssertionError):
    """A phase's result disagrees with its reference."""


def check(ok, msg):
    # an explicit raise: a bare assert vanishes under python -O
    if not ok:
        raise ParityError(msg)


def log(msg):
    print(msg, flush=True)


def steady_ms(fn, iters=5):
    """Median ms of ``fn()`` after one warm-up call, each call waited for
    with ``jax.block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def elevation_diff(mean_a, mean_b, count):
    """Max |difference| of two mean-elevation grids over occupied cells,
    and whether every cell is within 1e-3 deg + 0.1 deg / count: atomics
    add in a run-dependent order (the 1e-3 deg term), and the sorted
    oracle's f32 in-chunk prefix sums carry up to ~0.1 deg of absolute
    error on a cell's elevation SUM (ops.regrid._chunked_prefix), which
    only shows on cells with few samples."""
    occ = count > 0
    d = np.abs(mean_a[occ] - mean_b[occ])
    return float(d.max()), bool(np.all(d <= 1e-3 + 0.1 / count[occ]))


def report_time(phase, what, ms):
    log(f"[{phase}] steady state: {what} {ms:.3f} ms ({CARD})")


def device_check():
    """Phase 0: the default JAX backend must be a GPU."""
    global CARD
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; the default JAX backend "
                         f"is {dev.platform!r}")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[0] device: {dev.platform} {dev.device_kind}, {len(devs)} "
        f"device(s), jax {jax.__version__}")
    log(f"[0] card: {CARD}")
    for mod in ("PIL", "cv2", "matplotlib", "h5py"):
        try:
            importlib.import_module(mod)
            log(f"[0] import {mod}: ok")
        except ImportError:
            log(f"[0] import {mod}: missing")
    return dev


def frame_params(scale=1):
    """GeorefParams of the resource frame, downscaled by ``scale`` (CD
    scaled up, reference pixel down: same footprint, fewer pixels). Camera
    position and raw photo time pair as the f64 goldens were made."""
    from auromat_tpu.coordinates.wcs import TanWcs
    from auromat_tpu.io import fits
    from auromat_tpu.ops.georef import GeorefParams

    header = fits.read_header(os.path.join(RES, f"{FRAME}.wcs"))
    p = GeorefParams.from_wcs(
        TanWcs(header), np.array(fits.get_shifted_spacecraft_position(
            header)[:3]), fits.get_photo_time(header), altitude=110.0)
    if scale == 1:
        return p
    return dataclasses.replace(
        p, width=p.width // scale, height=p.height // scale,
        cd=tuple(tuple(v * scale for v in row) for row in p.cd),
        px_ref=p.px_ref / scale, py_ref=p.py_ref / scale)


def jittered(params, n, seed=0):
    """``n`` frames of ``params`` with the camera position jittered by
    1e-4 relative (distinct per-frame calibration, same footprint)."""
    rng = np.random.default_rng(seed)
    base = np.asarray(params.camera_pos)
    return [dataclasses.replace(params, camera_pos=tuple(
        base * (1.0 + 1e-4 * rng.standard_normal(3)))) for _ in range(n)]


def seeded_image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def phase_create_mapping(crop=None):
    """Phase 1: ``create_mapping`` in native float64 on the default device
    against the executed-reference golden grid (49 x 70 pixel corners).

    :param crop: None for the full frame, or (y0, x0, h, w) to georeference
        only that window (the header's reference pixel shifts with it)
    :returns: the mapping
    """
    import jax.numpy as jnp

    from auromat_tpu.io import fits
    from auromat_tpu.mapping.astrometry import create_mapping

    golden = np.load(os.path.join(RES, f"golden_georef_{FRAME}.npz"))
    header = dict(fits.read_header(os.path.join(RES, f"{FRAME}.wcs")))
    y0, x0, h, w = crop or (0, 0, int(header["IMAGEH"]),
                            int(header["IMAGEW"]))
    header["CRPIX1"] = float(header["CRPIX1"]) - x0
    header["CRPIX2"] = float(header["CRPIX2"]) - y0
    header["IMAGEW"], header["IMAGEH"] = w, h
    img = seeded_image(h, w)
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    t0 = time.perf_counter()
    m = create_mapping(header, img, pos, fits.get_photo_time(header),
                       altitude=float(golden["altitude"]), dtype=jnp.float64)
    ms = (time.perf_counter() - t0) * 1e3
    # golden samples sit on pixel corners (px = xs - 0.5); corner k of the
    # window is corner k + x0 of the frame
    xs, ys = golden["xs"], golden["ys"]
    sx = (xs >= x0) & (xs <= x0 + w)
    sy = (ys >= y0) & (ys <= y0 + h)
    sel = np.ix_(ys[sy] - y0, xs[sx] - x0)
    gsel = np.ix_(np.flatnonzero(sy), np.flatnonzero(sx))
    mlat, mlt = m.mLatMlt
    got = {"lat": m.lats, "lon": m.lons, "mlat": mlat, "mlt": mlt}
    worst = {}
    ref_nan = np.isnan(golden["lat"][gsel])
    for key, arr in got.items():
        a = np.asarray(arr.filled(np.nan), np.float64)[sel]
        ref = golden[key][gsel]
        check(np.array_equal(np.isnan(a), np.isnan(ref)),
              f"create_mapping {key}: NaN mask differs from the golden")
        ok = ~np.isnan(ref)
        d = np.abs(a[ok] - ref[ok])
        if key == "lon":
            d = np.minimum(d, 360.0 - d)
        if key == "mlt":
            d = np.minimum(d, 24.0 - d)
        worst[key] = float(d.max()) if d.size else 0.0
    check(int((~ref_nan).sum()) > 0, "no golden sample on the Earth")
    log(f"[1] create_mapping f64 {w}x{h}: max |err| vs golden lat "
        f"{worst['lat']:.3e} lon {worst['lon']:.3e} mlat {worst['mlat']:.3e}"
        f" deg, mlt {worst['mlt']:.3e} h; NaN masks identical "
        f"({int((~ref_nan).sum())} of {ref_nan.size} samples on Earth)")
    check(max(worst["lat"], worst["lon"], worst["mlat"]) < 1e-6,
          f"create_mapping f64 parity {worst} >= 1e-6 deg")
    check(worst["mlt"] < 1e-7, f"create_mapping mlt parity {worst['mlt']}")
    log(f"[1] first call (includes compile): create_mapping {ms:.1f} ms "
        f"({CARD})")
    return m


def phase_df64(time_scale=1):
    """Phase 2: the df64 chain (f32 pairs) on the default device against
    the golden; elevation against the f64 chain on the CPU. The timed
    call runs the frame downscaled by ``time_scale``."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.ops.georef import (_elevation_deg, _intersect,
                                        _pixel_dirs,
                                        georeference_points_df_full,
                                        georeference_points_df64_full)

    golden = np.load(os.path.join(RES, f"golden_georef_{FRAME}.npz"))
    p = frame_params()
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    px32, py32 = px.astype(np.float32), py.astype(np.float32)
    out = georeference_points_df64_full(p, px32, py32)
    with jax.default_device(jax.devices("cpu")[0]):
        vx, vy, vz = _pixel_dirs(p, jnp.asarray(px), jnp.asarray(py))
        ix, iy, iz = _intersect(p, vx, vy, vz, jnp.float64)
        elev64 = np.asarray(_elevation_deg(vx, vy, vz, ix, iy, iz))

    # the hit/miss boundary of the f64 reference (one strided step of
    # dilation): a grazing ray may flip there under f32 arithmetic
    ref_hit = ~np.isnan(golden["lat"])

    def dilate(mask):
        o = mask.copy()
        o[1:] |= mask[:-1]
        o[:-1] |= mask[1:]
        o[:, 1:] |= mask[:, :-1]
        o[:, :-1] |= mask[:, 1:]
        return o

    band = dilate(ref_hit & dilate(~ref_hit)) | dilate(
        ~ref_hit & dilate(ref_hit))
    worst = {}
    refs = {k: golden[k] for k in ("lat", "lon", "mlat", "mlt")}
    refs["elevation"] = elev64
    for key, ref in refs.items():
        a = out[key]
        check(np.array_equal(np.isnan(a[~band]), np.isnan(ref[~band])),
              f"df64 {key}: NaN mask differs off the horizon band")
        ok = ~np.isnan(a) & ~np.isnan(ref)
        d = np.abs(a[ok] - ref[ok])
        if key == "lon":
            d = np.minimum(d, 360.0 - d)
        if key == "mlt":
            d = np.minimum(d, 24.0 - d) * 15.0  # h -> deg
        worst[key] = float(d.max())
    flips = int((np.isnan(out["lat"]) != ~ref_hit).sum())
    log(f"[2] df64 chain: max |err| lat {worst['lat']:.3e} lon "
        f"{worst['lon']:.3e} mlat {worst['mlat']:.3e} mlt "
        f"{worst['mlt']:.3e} elevation {worst['elevation']:.3e} deg; NaN "
        f"masks identical off the horizon band, {flips} flips in it "
        f"({int(band.sum())} band samples)")
    check(max(worst.values()) < 1e-6, f"df64 parity {worst} >= 1e-6 deg")
    check(flips <= 0.05 * band.sum(), f"df64: {flips} horizon flips")
    fw = frame_params(time_scale)
    pxf = np.broadcast_to(np.arange(fw.width, dtype=np.float32)[None, :],
                          (fw.height, fw.width))
    pyf = np.broadcast_to(np.arange(fw.height, dtype=np.float32)[:, None],
                          (fw.height, fw.width))
    pxf, pyf = jax.device_put(pxf), jax.device_put(pyf)
    report_time(2, f"df64 full-variable chain, {fw.width}x{fw.height}",
                steady_ms(lambda: georeference_points_df_full(fw, pxf, pyf)))


def phase_resample(mapping, px_per_deg=25, route=None):
    """Phase 3: ``resample(method='mean')`` on the default device (the
    device's binning route, or ``route``) against ``bin_method='sorted'``
    on the CPU."""
    import jax

    from auromat_tpu.backend import mean_bin_method
    from auromat_tpu.ops.regrid import bin_mean, fixed_grid
    from auromat_tpu.resample import resample

    cpu = jax.devices("cpu")[0]
    route = route or mean_bin_method()
    t0 = time.perf_counter()
    r_dev = resample(mapping, px_per_deg=px_per_deg, method="mean",
                     bin_method=route)
    ms = (time.perf_counter() - t0) * 1e3
    with jax.default_device(cpu):
        r_cpu = resample(mapping, px_per_deg=px_per_deg, method="mean",
                         bin_method="sorted")
    # per-cell sample counts of the same grid on both sides (this frame
    # crosses neither a pole nor the antimeridian, so resample's grid is
    # the plain bounding-box grid)
    bb = mapping.boundingBox
    grid = fixed_grid(px_per_deg, bb.latSouth, bb.latNorth, bb.lonWest,
                      bb.lonEast)
    la = np.asarray(mapping.latsCenter.filled(np.nan))
    lo = np.asarray(mapping.lonsCenter.filled(np.nan))
    ones = np.ones(la.shape + (1,))
    c_dev = np.asarray(bin_mean(grid, la, lo, ones, method=route)[0])
    with jax.default_device(cpu):
        c_cpu = np.asarray(bin_mean(grid, la, lo, ones, method="sorted")[0])
    check(np.array_equal(c_dev, c_cpu), "resample counts differ")
    a = np.ma.getdata(r_dev.img).astype(int)
    b = np.ma.getdata(r_cpu.img).astype(int)
    ma_, mb_ = np.ma.getmaskarray(r_dev.img), np.ma.getmaskarray(r_cpu.img)
    check(np.array_equal(ma_, mb_), "resample image masks differ")
    d = np.abs(a - b)[~ma_]
    n_cells = int((~ma_).sum())
    off = int((d > 0).sum())
    e_dev = np.ma.filled(r_dev.elevation, np.nan)
    e_cpu = np.ma.filled(r_cpu.elevation, np.nan)
    check(np.array_equal(np.isnan(e_dev), np.isnan(e_cpu)),
          "resample elevation masks differ")
    ok = ~np.isnan(e_cpu)
    de = float(np.abs(e_dev[ok] - e_cpu[ok]).max())
    log(f"[3] resample mean ({route} on device vs sorted on CPU), grid "
        f"{grid.n_lat}x{grid.n_lon}: counts identical, uint8 max diff "
        f"{int(d.max()) if d.size else 0} on {off} of {n_cells} values, "
        f"elevation max diff {de:.3e} deg")
    check(d.size > 0 and d.max() <= 1, "resample uint8 differs by > 1")
    check(off <= 1e-4 * n_cells, f"resample: {off} uint8 values differ")
    check(de < 1e-4, f"resample elevation differs by {de}")
    log(f"[3] first call (includes compile): resample {ms:.1f} ms ({CARD})")


def phase_fused(params, grid_args=REGIONAL, route=None):
    """Phase 4: the fused f32 step (``georegrid_partial``) with the
    device's route against the sorted oracle on the same device."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.backend import mean_bin_method
    from auromat_tpu.ops.georef import DynGeorefParams
    from auromat_tpu.ops.georegrid import georegrid_mean, georegrid_partial
    from auromat_tpu.ops.regrid import fixed_grid

    route = route or mean_bin_method()
    grid = fixed_grid(*grid_args)
    dyn = DynGeorefParams.from_static(params, dtype=jnp.float32)
    img = jax.device_put(np.ascontiguousarray(seeded_image(
        params.height, params.width).transpose(2, 0, 1)).astype(np.float32))
    c_r, s_r = (np.asarray(a) for a in georegrid_partial(
        grid, dyn, img, bin_method=route))
    c_s, s_s = (np.asarray(a) for a in georegrid_partial(
        grid, dyn, img, bin_method="sorted"))
    check(c_r.sum() > 0, "fused step binned no samples")
    check(np.array_equal(c_r, c_s), f"fused {route} counts != sorted")
    check(np.array_equal(s_r[..., :3], s_s[..., :3]),
          f"fused {route} R/G/B sums != sorted")
    occ = c_s > 0
    de, de_ok = elevation_diff(s_r[..., 3] / np.maximum(c_r, 1),
                               s_s[..., 3] / np.maximum(c_s, 1), c_s)
    log(f"[4] fused f32 step {params.width}x{params.height} -> "
        f"{grid.n_lat}x{grid.n_lon}: {route} vs sorted counts and R/G/B "
        f"sums identical ({int(c_r.sum())} samples), mean elevation max "
        f"diff {de:.3e} deg")
    check(de_ok, f"fused elevation differs by {de}")
    mpix = params.width * params.height / 1e6
    ms = steady_ms(lambda: georegrid_mean(grid, dyn, img, bin_method=route),
                   iters=20)
    report_time(4, f"fused georef+regrid ({route}), {mpix:.2f} MPix", ms)


def phase_mosaic(params, grid_args, n_frames=16, batch=8, route=None,
                 label=""):
    """Phase 5: ``mosaic_sequence`` on a 1-device mesh, two bursts of
    jittered frames, with the device's route against the sorted oracle."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.backend import mean_bin_method
    from auromat_tpu.ops.georef import DynGeorefParams
    from auromat_tpu.ops.regrid import fixed_grid
    from auromat_tpu.parallel import (make_grid_sharded_mosaic_step,
                                      make_mesh, mosaic_sequence)

    route = route or mean_bin_method()
    grid = fixed_grid(*grid_args)
    mesh = make_mesh(jax.devices()[:1], dp=1, sp=1)
    frames = jittered(params, n_frames)
    h, w = params.height, params.width
    imgs = jax.device_put(np.broadcast_to(
        seeded_image(h, w)[None], (batch, h, w, 3)).astype(np.float32))

    def bursts():
        for i in range(0, n_frames, batch):
            yield frames[i:i + batch], imgs[:len(frames[i:i + batch])]

    def seq(method):
        return mosaic_sequence(mesh, grid, bursts(), batch=batch,
                               bin_method=method)

    def run(method):
        c, m = seq(method)
        return (np.asarray(c)[:grid.n_lat],
                np.asarray(m, np.float64)[:grid.n_lat])

    c_r, m_r = run(route)
    c_s, m_s = run("sorted")
    check(c_r.sum() > 0, "mosaic binned no samples")
    check(np.array_equal(c_r, c_s), f"mosaic {route} counts != sorted")
    check(np.array_equal(np.isnan(m_r), np.isnan(m_s)),
          "mosaic NaN masks differ")
    occ = c_s > 0
    # R/G/B sums are integers: exact in f32 below 2^24, else one rounding
    exact = occ & (c_s * 255.0 < 2 ** 24)
    check(np.array_equal(m_r[..., :3][exact], m_s[..., :3][exact]),
          f"mosaic {route} R/G/B != sorted")
    big = occ & ~exact
    rel = (float(np.abs(m_r[..., :3][big] / m_s[..., :3][big] - 1).max())
           if big.any() else 0.0)
    check(rel < 1e-6, f"mosaic R/G/B rel diff {rel}")
    de, de_ok = elevation_diff(m_r[..., 3], m_s[..., 3], c_s)
    check(de_ok, f"mosaic elevation differs by {de}")
    dyn = DynGeorefParams.stack(frames[:batch], dtype=jnp.float32)
    compiled = make_grid_sharded_mosaic_step(
        mesh, grid, h, w, bin_method=route, finalize=False).lower(
            dyn, imgs).compile()
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[5{label}] mosaic_sequence {n_frames} frames -> {grid.n_lat}x"
        f"{grid.n_lon}: {route} vs sorted counts identical "
        f"({int(c_r.sum())} samples), R/G/B exact on {int(exact.sum())} "
        f"cells (rel {rel:.1e} on {int(big.sum())}), elevation max diff "
        f"{de:.3e} deg")
    log(f"[5{label}] step memory_analysis: {compiled.memory_analysis()}")
    log(f"[5{label}] peak_bytes_in_use: "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    ms = steady_ms(lambda: seq(route), iters=3)
    report_time(f"5{label}", f"mosaic_sequence {n_frames} frames "
                f"({route}), {ms / n_frames:.3f} ms/frame;", ms)


def take_best_inputs(n_stations=24, size=256, seed=1):
    """The 24-station synthetic all-sky network of the benchmark:
    calibration grids reprojected to 110 km, random gray imagery +
    elevation payload, priority = -elevation."""
    from auromat_tpu.constants import WGS84_A, WGS84_B
    from auromat_tpu.coordinates.intersection import \
        ellipsoid_line_intersection
    from auromat_tpu.coordinates.transform import (ecef_to_geodetic,
                                                   geodetic_to_ecef_zero)
    from auromat_tpu.mapping import miracle
    from auromat_tpu.mapping.themis import reproject_batch
    from auromat_tpu.utils import host_f64_device

    rng = np.random.default_rng(seed)
    st_lats = 51.0 + 11.0 * rng.random(n_stations)
    st_lons = -150.0 + 90.0 * rng.random(n_stations)
    lats_s, lons_s, elevs_s = [], [], []
    for i in range(n_stations):
        cal = miracle.CalibrationData(
            station=f"S{i:02d}", validFrom=None, validTo=None,
            lat=float(st_lats[i]), lon=float(st_lons[i]),
            xc=size / 2 * 512 / size, yc=size / 2 * 512 / size,
            k=155.0, rotation=0.0, boundingBoxSimple=None)
        az, el = miracle.fisheye_az_el(cal, size, corner=False)
        with host_f64_device():
            ox, oy, oz = geodetic_to_ecef_zero(np.deg2rad(cal.lat),
                                               np.deg2rad(cal.lon))
            origin = np.array([float(ox), float(oy), float(oz)])
            dirs = miracle.az_el_to_geo_directions(cal, az, el)
            inter = np.asarray(ellipsoid_line_intersection(
                WGS84_A + 110.0, WGS84_B + 110.0, origin, np.asarray(dirs)))
            la, lo = ecef_to_geodetic(inter[..., 0], inter[..., 1],
                                      inter[..., 2])
        lats_s.append(np.rad2deg(np.asarray(la)))
        lons_s.append(np.rad2deg(np.asarray(lo)))
        elevs_s.append(np.asarray(el))
    la, lo = reproject_batch(np.stack([st_lats, st_lons], axis=-1),
                             np.stack(lats_s), np.stack(lons_s), 110.0, 100.0)
    gray = rng.random((n_stations, size, size)).astype(np.float32) * 255.0
    el = np.stack(elevs_s)
    data = np.stack([gray, np.broadcast_to(el, gray.shape)], axis=-1)
    return (la.astype(np.float32), lo.astype(np.float32),
            (-el).astype(np.float32), data.astype(np.float32))


def phase_take_best(n_stations=24, size=256):
    """Phase 6: the take-best ASI composite (``bin_take_best`` and the
    planned ``plan_take_best``/``apply_take_best``) on the default device
    against the same calls on the CPU: identical grids."""
    import jax

    from auromat_tpu.ops.regrid import (apply_take_best, bin_take_best,
                                        fixed_grid, plan_take_best)

    grid = fixed_grid(10, 40.0, 72.0, -160.0, -50.0)
    la, lo, pri, data = take_best_inputs(n_stations, size)

    def composite():
        comp, best = bin_take_best(grid, la, lo, pri, data)
        plan = jax.jit(lambda a, b, c: plan_take_best(grid, a, b, c))(
            la, lo, pri)
        return (np.asarray(comp), np.asarray(best),
                np.asarray(jax.jit(apply_take_best)(plan, data)))

    dev = composite()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = composite()
    for name, a, b in zip(("bin_take_best", "best priority",
                           "apply_take_best"), dev, cpu):
        check(np.array_equal(a, b, equal_nan=True),
              f"take-best {name}: device != CPU")
    filled = int((~np.isnan(dev[0][..., 0])).sum())
    check(filled > 0, "take-best composite is empty")
    check(np.array_equal(dev[0], dev[2], equal_nan=True),
          "planned composite != bin_take_best")
    log(f"[6] take-best composite {n_stations} stations x {size}^2 -> "
        f"{grid.n_lat}x{grid.n_lon}: device == CPU bit for bit "
        f"({filled} cells filled)")
    args = [jax.device_put(a) for a in (la, lo, pri, data)]
    step = jax.jit(lambda a, b, c, d: bin_take_best(grid, a, b, c, d))
    report_time(6, "bin_take_best composite", steady_ms(lambda: step(*args)))


def phase_generic(step=16, codes=("ZEA", "HPX", "QSC"), time_scale=1):
    """Phase 7: generic-projection georeferencing in f32 on the default
    device against f64 on the CPU, at the floors tests/test_georef.py
    states (max < 1e-2 deg, median lat < 1e-4 deg). The timed call runs
    the frame downscaled by ``time_scale``."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.coordinates.wcs import make_wcs
    from auromat_tpu.io import fits
    from auromat_tpu.ops.georef import (georeference_generic,
                                        georeference_points_generic)

    header = dict(fits.read_header(os.path.join(RES, f"{FRAME}.wcs")))
    p = frame_params()
    px, py = np.meshgrid(np.arange(0, p.width, step, dtype=np.float64),
                         np.arange(0, p.height, step, dtype=np.float64))
    cpu = jax.devices("cpu")[0]
    for code in codes:
        # theta0=0 families need the zenithal header's LONPOLE dropped
        h2 = {k: v for k, v in header.items()
              if k.upper() not in ("LONPOLE", "LATPOLE")}
        h2["CTYPE1"], h2["CTYPE2"] = f"RA---{code}", f"DEC--{code}"
        wcs = make_wcs(h2)
        la32, lo32 = (np.asarray(a, np.float64)
                      for a in georeference_points_generic(
                          wcs, p, px.astype(np.float32),
                          py.astype(np.float32), jnp.float32))
        with jax.default_device(cpu):
            la64, lo64 = (np.asarray(a) for a in georeference_points_generic(
                wcs, p, jnp.asarray(px), jnp.asarray(py), jnp.float64))
        mism = float((np.isnan(la32) != np.isnan(la64)).mean())
        both = ~np.isnan(la32) & ~np.isnan(la64)
        check(both.sum() > 0, f"{code}: no georeferenced pixel")
        dla = np.abs(la32[both] - la64[both])
        dlo = np.abs(lo32[both] - lo64[both])
        dlo = np.minimum(dlo, 360.0 - dlo)
        worst = float(max(dla.max(), dlo.max()))
        log(f"[7] generic {code} f32 (device) vs f64 (CPU): max {worst:.3e}"
            f" deg, median lat {np.median(dla):.3e} deg, mask mismatch "
            f"{mism:.2e} (n={int(both.sum())})")
        check(worst < 1e-2, f"{code}: f32 parity {worst} >= 1e-2 deg")
        check(np.median(dla) < 1e-4, f"{code}: median lat error too large")
        # a grazing ray may flip hit/miss under the device's f32 rounding
        check(mism <= 5e-4, f"{code}: {mism:.2e} of masks differ")
    wz = dict(header)
    wz["CTYPE1"], wz["CTYPE2"] = "RA---ZEA", "DEC--ZEA"
    pt = frame_params(time_scale)
    for k, v in (("IMAGEW", pt.width), ("IMAGEH", pt.height),
                 ("CD1_1", pt.cd[0][0]), ("CD1_2", pt.cd[0][1]),
                 ("CD2_1", pt.cd[1][0]), ("CD2_2", pt.cd[1][1]),
                 ("CRPIX1", pt.px_ref), ("CRPIX2", pt.py_ref)):
        wz[k] = v
    wzea = make_wcs(wz)
    fn = jax.jit(lambda: georeference_generic(wzea, pt, True, True,
                                              jnp.float32))
    report_time(7, f"generic ZEA georef f32, {pt.width}x{pt.height}",
                steady_ms(fn))


def reduce_scatter_bytes(hlo_text):
    """Output bytes of every reduce-scatter in compiled HLO text."""
    sizes = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "u32": 4}
    total = 0
    for m in re.finditer(r"= (\w+)\[([0-9,]*)\][^=]* reduce-scatter\(",
                         hlo_text):
        dims = [int(d) for d in m.group(2).split(",") if d]
        total += int(np.prod(dims)) * sizes[m.group(1)]
    return total


def phase_multichip(params, grid_args=GLOBAL, batch=8, route=None):
    """The 4-device path: the grid-sharded step on (dp=4, sp=1) and
    (dp=2, sp=2) meshes and ``mosaic_sequence`` on 4 devices, each
    against the 1-device result of this process."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.backend import mean_bin_method
    from auromat_tpu.ops.georef import DynGeorefParams
    from auromat_tpu.ops.regrid import fixed_grid
    from auromat_tpu.parallel import (make_grid_sharded_mosaic_step,
                                      make_mesh, mosaic_sequence)

    devs = jax.devices()
    check(len(devs) >= 4, f"--multichip needs 4 devices, found {len(devs)}")
    route = route or mean_bin_method()
    grid = fixed_grid(*grid_args)
    h, w = params.height, params.width
    frames = jittered(params, 2 * batch)
    dyn = DynGeorefParams.stack(frames[:batch], dtype=jnp.float32)
    imgs_np = np.broadcast_to(seeded_image(h, w)[None],
                              (batch, h, w, 3)).astype(np.float32)

    def compare(tag, c, m, c1, m1):
        c, m = np.asarray(c)[:grid.n_lat], np.asarray(m)[:grid.n_lat]
        check(c.sum() > 0, f"{tag}: no samples")
        check(np.array_equal(c, c1), f"{tag}: counts != 1-device")
        check(np.array_equal(np.isnan(m), np.isnan(m1)),
              f"{tag}: NaN masks != 1-device")
        occ = c1 > 0
        check(np.array_equal(m[..., :3][occ], m1[..., :3][occ]),
              f"{tag}: R/G/B != 1-device")
        de = float(np.abs(m[..., 3][occ] - m1[..., 3][occ]).max())
        check(de < 1e-3, f"{tag}: elevation differs by {de}")
        return de

    mesh1 = make_mesh(devs[:1], dp=1, sp=1)
    step1 = make_grid_sharded_mosaic_step(mesh1, grid, h, w,
                                          bin_method=route)
    c1, m1 = (np.asarray(a)[:grid.n_lat] for a in step1(dyn, imgs_np))
    for dp, sp in ((4, 1), (2, 2)):
        mesh = make_mesh(devs[:4], dp=dp, sp=sp)
        step = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                             bin_method=route)
        imgs = jax.device_put(imgs_np, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp", "sp")))
        compiled = step.lower(dyn, imgs).compile()
        rs = reduce_scatter_bytes(compiled.as_text())
        c, m = compiled(dyn, imgs)
        de = compare(f"dp={dp} sp={sp}", c, m, c1, m1)
        log(f"[mc] grid-sharded step dp={dp} sp={sp}, {batch} frames -> "
            f"{grid.n_lat}x{grid.n_lon} ({route}): counts and R/G/B == "
            f"1-device, elevation max diff {de:.3e} deg; reduce-scatter "
            f"output {rs} bytes per device")
        report_time("mc", f"grid-sharded step dp={dp} sp={sp}, {batch} "
                    f"frames", steady_ms(lambda: compiled(dyn, imgs)))

    def seq(mesh):
        c, m = mosaic_sequence(mesh, grid, [(frames[:batch], imgs_np),
                                            (frames[batch:], imgs_np)],
                               batch=batch, bin_method=route)
        return c, m

    c1s, m1s = (np.asarray(a)[:grid.n_lat] for a in seq(mesh1))
    mesh4 = make_mesh(devs[:4], dp=4, sp=1)
    c4, m4 = seq(mesh4)
    de = compare("mosaic_sequence 4 devices", c4, m4, c1s, m1s)
    log(f"[mc] mosaic_sequence {2 * batch} frames on 4 devices == 1 device"
        f" (counts, R/G/B), elevation max diff {de:.3e} deg")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-device path against 1 device")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "auromat_tpu")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (auromat_tpu/ not found beside it)")
    sys.path.insert(0, REPO)

    dev = device_check()
    import jax

    from auromat_tpu.backend import enable_compile_cache

    log(f"[0] compile cache: {enable_compile_cache()}")
    t_all = time.perf_counter()
    params = frame_params()

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        log(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s "
            f"(compiles included)")
        return out

    if args.multichip:
        timed("mc", phase_multichip, params)
    else:
        mapping = timed(1, phase_create_mapping)
        timed(2, phase_df64)
        timed(3, phase_resample, mapping)
        del mapping
        timed(4, phase_fused, params)
        timed("5a", phase_mosaic, params, REGIONAL, label="a")
        timed("5b", phase_mosaic, params, GLOBAL, label="b")
        timed(6, phase_take_best)
        timed(7, phase_generic)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
