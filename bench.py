"""Headline benchmark: georeference + regrid a 12 MP ISS frame on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "MPix/s/chip", "vs_baseline": N,
   ..., "device": {...}}

vs_baseline is measured throughput relative to the north-star target of
<10 ms for the 12.05 MPix frame (BASELINE.json) == 1205 MPix/s. The
``device`` entry names the platform, ``device_kind``, the device count and
the card's name and power limit (nvidia-smi). Needs a GPU: without one it
exits nonzero, as does any failing key. Everything timed is jitted and
waited for with ``jax.block_until_ready``; imagery is seeded uint8.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def time_amortized(fn, iters, n_batches=3):
    """Median per-call seconds: ``iters`` asynchronous dispatches per
    batch, the batch bounded by ``jax.block_until_ready`` on the last
    output (one warm-up call first)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts)), ts


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; the default JAX backend is "
                         f"{dev.platform!r}")
    sys.path.insert(0, REPO)
    from auromat_tpu.backend import enable_compile_cache, mean_bin_method

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from chip_smoke import seeded_image, take_best_inputs
    from auromat_tpu.coordinates.wcs import TanWcs, make_wcs
    from auromat_tpu.io import fits
    from auromat_tpu.ops.georef import (DynGeorefParams, GeorefParams,
                                        georeference_generic,
                                        georeference_points_df,
                                        georeference_points_df_full,
                                        georeference_points_generic)
    from auromat_tpu.ops.georegrid import georegrid_mean
    from auromat_tpu.ops.regrid import (apply_take_best, bin_take_best,
                                        fixed_grid, plan_take_best)
    from auromat_tpu.parallel import (make_grid_sharded_mosaic_step,
                                      mosaic_sequence)

    header = fits.read_header(
        os.path.join(REPO, "tests", "resources", "ISS030-E-102170_dc.wcs"))
    params = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header), altitude=110.0)
    h, w = params.height, params.width
    mpix = h * w / 1e6
    dtype = jnp.float32
    dyn = DynGeorefParams.from_static(params, dtype=dtype)
    grid = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)
    img = seeded_image(h, w).astype(np.float32)
    route = mean_bin_method()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())} | "
        f"{card} | binning route {route}")
    per_batch = int(os.environ.get("BENCH_PER_BATCH", 10))
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 axis_names=("dp", "sp"))

    # headline: the fused georef + regrid step
    forward = jax.jit(lambda img_chw: georegrid_mean(grid, dyn, img_chw))
    img_dev = jax.device_put(np.ascontiguousarray(img.transpose(2, 0, 1)))
    t0 = time.time()
    count, _ = jax.block_until_ready(forward(img_dev))
    log(f"compile+first run: {time.time() - t0:.1f}s")
    if not float(np.asarray(count).sum()) > 1e6:
        raise SystemExit("georef+regrid produced no samples")
    dt, batch_times = time_amortized(lambda: forward(img_dev), per_batch,
                                     n_batches=4)
    log(f"amortized step: {dt * 1e3:.3f} ms (batches: "
        f"{[round(t * 1e3, 3) for t in batch_times]})")

    # the grid-sharded mosaic step on a 1-device mesh, one frame: its
    # per-shard cost against the fused single-frame step
    gstep = make_grid_sharded_mosaic_step(mesh1, grid, h, w, channels=3,
                                          dtype=dtype)
    dyn1 = jax.device_put(DynGeorefParams.stack([params], dtype=dtype))
    imgs1 = jax.device_put(img[None])
    dt_sh, _ = time_amortized(lambda: gstep(dyn1, imgs1), per_batch)
    sharded_ms = round(dt_sh * 1e3, 3)
    log(f"grid-sharded step (1-device mesh): {sharded_ms} ms")

    # batched burst (BASELINE config 4): 8 frames through the fused step
    # inside ONE jit; sustained MPix/s
    nb = int(os.environ.get("BENCH_BURST", 8))
    dynb = jax.device_put(DynGeorefParams.stack([params] * nb, dtype=dtype))

    @jax.jit
    def burst(imgs_chw, dynb):
        outs = []
        for i in range(nb):
            d = jax.tree.map(lambda x: x[i], dynb)
            outs.append(georegrid_mean(grid, d, imgs_chw[i]))
        return (sum(o[0] for o in outs), jnp.stack([o[1] for o in outs]))

    imgs_b = jax.device_put(np.broadcast_to(
        img.transpose(2, 0, 1)[None], (nb, 3, h, w)).copy())
    burst_dt, _ = time_amortized(lambda: burst(imgs_b, dynb),
                                 max(per_batch // 2, 2))
    burst_mpix_s = round(nb * mpix / burst_dt, 1)
    log(f"batched burst ({nb} frames): {burst_dt * 1e3:.3f} ms = "
        f"{burst_mpix_s} MPix/s sustained")

    # the same burst through the grid-sharded step on a 1-device mesh —
    # the code path production uses (provider bursts -> mosaic_sequence)
    gstep8 = make_grid_sharded_mosaic_step(mesh1, grid, h, w, channels=3,
                                           dtype=dtype)
    imgs8 = jax.device_put(np.broadcast_to(img[None], (nb, h, w, 3)).copy())
    dt8, _ = time_amortized(lambda: gstep8(dynb, imgs8),
                            max(per_batch // 2, 2))
    burst8_sharded_ms = round(dt8 * 1e3 / nb, 3)
    log(f"sharded mosaic step burst ({nb} frames, 1-device mesh): "
        f"{burst8_sharded_ms} ms/frame")

    # config 4 at its stated scale: a 100-frame ISS burst through
    # mosaic_sequence (batch-8 chunks, jittered per-frame calibration —
    # one compiled step serves every chunk); imagery rides a device-
    # resident 8-frame buffer, calibration streams from the host
    n100 = int(os.environ.get("BENCH_BURST100_N", 100))
    rng = np.random.default_rng(0)
    base_pos = np.asarray(params.camera_pos)
    p100 = [dataclasses.replace(params, camera_pos=tuple(
        base_pos * (1.0 + 1e-4 * rng.standard_normal(3))))
        for _ in range(n100)]
    imgs_dev = jax.device_put(np.broadcast_to(img[None], (8, h, w, 3)).copy())

    def run100():
        bursts = ((p100[i:i + 8], imgs_dev[:len(p100[i:i + 8])])
                  for i in range(0, n100, 8))
        return mosaic_sequence(mesh1, grid, bursts, batch=8, dtype=dtype)

    jax.block_until_ready(run100())
    t0 = time.perf_counter()
    jax.block_until_ready(run100())
    dt100 = time.perf_counter() - t0
    burst100_sharded_ms = round(dt100 * 1e3 / n100, 3)
    log(f"{n100}-frame sequence through mosaic_sequence (1-device mesh): "
        f"{burst100_sharded_ms} ms/frame ({dt100:.3f} s total)")

    # BASELINE config 5: the frame burst binned into the 0.05 deg GLOBAL
    # grid (3599 x 7199) through the grid-sharded step, 1-device mesh
    g5 = fixed_grid(20, -89.999, 89.999, -179.999, 179.999)
    g5step = make_grid_sharded_mosaic_step(mesh1, g5, h, w, channels=3,
                                           dtype=dtype)
    nb5 = int(os.environ.get("BENCH_CONFIG5_B", 4))
    dyn5 = jax.device_put(DynGeorefParams.stack([params] * nb5, dtype=dtype))
    imgs5 = jax.device_put(np.broadcast_to(img[None], (nb5, h, w, 3)).copy())
    dt5, _ = time_amortized(lambda: g5step(dyn5, imgs5),
                            max(per_batch // 2, 2))
    config5_ms = round(dt5 * 1e3 / nb5, 3)
    log(f"config-5 global 0.05deg mosaic step (1-device mesh, {nb5}-frame "
        f"burst): {config5_ms} ms/frame")

    # BASELINE config 2: 24 synthetic all-sky stations x 256x256
    # composited by elevation priority (bin_take_best); calibration is
    # built on the host, untimed (static per night)
    la, lo, pri, data24 = (jax.device_put(a) for a in take_best_inputs())
    g24 = fixed_grid(10, 40.0, 72.0, -160.0, -50.0)
    take_best = jax.jit(lambda a, b, c, d: bin_take_best(g24, a, b, c, d))
    dt24, _ = time_amortized(lambda: take_best(la, lo, pri, data24),
                             per_batch)
    themis24_ms = round(dt24 * 1e3, 3)
    log(f"themis24 composite (24 stations, bin_take_best, "
        f"{g24.n_lat}x{g24.n_lon} grid): {themis24_ms} ms")
    # production cadence: plan once (one sort), gather per exposure
    plan = jax.jit(lambda a, b, c: plan_take_best(g24, a, b, c))(la, lo, pri)
    apply_fn = jax.jit(apply_take_best)
    dt24a, _ = time_amortized(lambda: apply_fn(plan, data24), per_batch)
    themis24_apply_ms = round(dt24a * 1e3, 3)
    log(f"themis24 planned composite (per-exposure gather): "
        f"{themis24_apply_ms} ms")

    # full-precision (df64) chain: lat/lon, then every exported variable
    px = jax.device_put(np.broadcast_to(
        np.arange(w, dtype=np.float32)[None, :], (h, w)))
    py = jax.device_put(np.broadcast_to(
        np.arange(h, dtype=np.float32)[:, None], (h, w)))
    df64 = jax.jit(lambda a, b: georeference_points_df(params, a, b))
    df64_ms = round(time_amortized(lambda: df64(px, py), per_batch)[0]
                    * 1e3, 3)
    log(f"df64 full-precision georef: {df64_ms} ms")
    df64_full_ms = round(time_amortized(
        lambda: georeference_points_df_full(params, px, py), per_batch)[0]
        * 1e3, 3)
    log(f"df64 full-variable georef (lat/lon/elev/mlat/mlt): "
        f"{df64_full_ms} ms")
    df64_zen_full_ms = round(time_amortized(
        lambda: georeference_points_df_full(params, px, py,
                                            projection="ZEA"),
        per_batch)[0] * 1e3, 3)
    log(f"df64 full-variable georef (ZEA radial law): {df64_zen_full_ms} ms")

    # generic-projection (non-TAN) georef: the production-shaped call for
    # a ZEA header, and f32 parity against the CPU f64 oracle for ZEA,
    # HPX and QSC (f32 floor ~1.6e-3 deg, tests/test_georef.py)
    hdr = dict(header)

    def swap(code):
        h2 = {k: v for k, v in hdr.items()
              if k.upper() not in ("LONPOLE", "LATPOLE")}
        h2["CTYPE1"], h2["CTYPE2"] = f"RA---{code}", f"DEC--{code}"
        return make_wcs(h2)

    wcs_zea = swap("ZEA")
    gfn = jax.jit(lambda: georeference_generic(wcs_zea, params, True, True,
                                               jnp.float32))
    generic_ms = round(time_amortized(gfn, per_batch)[0] * 1e3, 3)
    log(f"generic-projection georef (ZEA, full frame, f32): {generic_ms} ms")
    cpu = jax.devices("cpu")[0]
    pxg, pyg = np.meshgrid(np.arange(0, w, 8, dtype=np.float64),
                           np.arange(0, h, 8, dtype=np.float64))
    worst = 0.0
    for code in ("ZEA", "HPX", "QSC"):
        wcsf = swap(code)
        lat_t, lon_t = (np.asarray(a, np.float64)
                        for a in georeference_points_generic(
                            wcsf, params, pxg.astype(np.float32),
                            pyg.astype(np.float32), jnp.float32))
        with jax.default_device(cpu):
            lat_c, lon_c = (np.asarray(a)
                            for a in georeference_points_generic(
                                wcsf, params, jnp.asarray(pxg),
                                jnp.asarray(pyg), jnp.float64))
        both = ~np.isnan(lat_t) & ~np.isnan(lat_c)
        dla = np.abs(lat_t[both] - lat_c[both])
        dlo = np.abs(lon_t[both] - lon_c[both])
        dlo = np.minimum(dlo, 360.0 - dlo)
        fam = float(max(dla.max(), dlo.max()))
        mism = float((np.isnan(lat_t) != np.isnan(lat_c)).mean())
        log(f"generic parity {code}: max {fam:.3e} deg, mask mismatch "
            f"{mism:.2e}")
        if mism > 5e-4:
            raise SystemExit(f"generic parity {code}: {mism:.2e} of the "
                             "masks differ from the CPU f64 oracle")
        worst = max(worst, fam)
    generic_parity_deg = float(f"{worst:.3e}")

    value = mpix / dt
    baseline = 12.05 / 10e-3  # north-star: 12 MPix in 10 ms
    print(json.dumps({
        "metric": f"georef+regrid 12MP ISS frame ({dev.platform}, f32)",
        "value": round(value, 2),
        "unit": "MPix/s/chip",
        "vs_baseline": round(value / baseline, 4),
        "df64_georef_ms": df64_ms,
        "df64_full_ms": df64_full_ms,
        "df64_zen_full_ms": df64_zen_full_ms,
        "sharded_1dev_ms": sharded_ms,
        "burst8_mpix_s": burst_mpix_s,
        "burst8_sharded_ms": burst8_sharded_ms,
        "burst100_sharded_ms": burst100_sharded_ms,
        "config5_ms": config5_ms,
        "themis24_ms": themis24_ms,
        "themis24_apply_ms": themis24_apply_ms,
        "generic_ms": generic_ms,
        "generic_parity_deg": generic_parity_deg,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
