"""Time every XLA mean-binning variant inside the fused f32 step.

Each variant runs as the production step does: georeference the frame(s)
(f32), compute bin indices, bin count + R/G/B + elevation, all in one jit.
Two grids: the 12 MP regional grid (540 x 525, one frame) and the 0.05 deg
global grid (3599 x 7199, an 8-frame burst). Times are steady state after
warm-up, synced with ``block_until_ready``. Counts are checked against the
``sorted`` oracle. A profiler trace of the fastest variant on each grid is
reduced to its top device operations.

Needs an accelerator::

    python tools/binning_sweep.py [--only scatter,sorted] [--trace-dir DIR]
"""

import argparse
import dataclasses
import glob
import importlib
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("scatter", "segment", "sorted", "sorted_gather", "sorted_packed",
            "window", "tiled")
# bin_partial_tiled builds an (tiles, pixels, n_lon) one-hot and unrolls
# one overlap-add per 8 grid rows: at 7199 columns x 450 row groups that is
# tens of GB and a multi-minute compile, so it runs on the regional grid only
REGIONAL_ONLY = ("tiled",)


def _binner(name):
    from auromat_tpu.ops.regrid import (bin_partial, bin_partial_tiled,
                                        bin_partial_window)

    if name == "window":
        return bin_partial_window, True
    if name == "tiled":
        return bin_partial_tiled, True
    return (lambda g, la, lo, d: bin_partial(g, la, lo, d, name)), False


def make_step(grid, h, w, name):
    """Fused georef + binning over a (B, h, w, 3) burst -> (count, sums)."""
    import jax
    import jax.numpy as jnp

    from auromat_tpu.ops.georef import georef_latlon_dyn

    binner, structured = _binner(name)
    f32 = jnp.float32

    @jax.jit
    def step(dynb, imgs):
        px = jnp.broadcast_to(jnp.arange(w, dtype=f32)[None, :], (h, w))
        py = jnp.broadcast_to(jnp.arange(h, dtype=f32)[:, None], (h, w))

        def georef(d):
            out = georef_latlon_dyn(d, px, py, dtype=f32, with_elevation=True)
            return out["lat"], out["lon"], out["elevation"]

        lat, lon, elev = jax.vmap(georef)(dynb)
        data = jnp.concatenate([imgs, elev[..., None]], axis=-1)
        if not structured:
            return binner(grid, lat, lon, data)
        # structured binners take one (h, w) frame: fold the burst
        cnt, sums = binner(grid, lat[0], lon[0], data[0])
        if lat.shape[0] == 1:
            return cnt, sums

        def body(acc, x):
            c, s = binner(grid, *x)
            return (acc[0] + c, acc[1] + s), None

        (cnt, sums), _ = jax.lax.scan(body, (cnt, sums),
                                      (lat[1:], lon[1:], data[1:]))
        return cnt, sums

    return step


def _device_ops(trace_dir, top=10):
    """Top device events of the newest trace under ``trace_dir``, per line
    of the device planes: {line name: [(event name, total ms, calls)]}."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            tot, calls = {}, {}
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns / 1e6
                calls[ev.name] = calls.get(ev.name, 0) + 1
            ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
            lines[f"{plane.name} {line.name}"] = [
                (k, v, calls[k]) for k, v in ranked]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--trace-dir", default=None,
                    help="write a profiler trace of each grid's winner here")
    args = ap.parse_args(argv)

    import jax

    from auromat_tpu.backend import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("binning_sweep needs an accelerator")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f" | {smi} | jax {jax.__version__}", flush=True)
    for mod in ("PIL", "cv2", "matplotlib", "h5py"):
        try:
            importlib.import_module(mod)
            print(f"import {mod}: ok")
        except ImportError as e:
            print(f"import {mod}: missing ({e})")

    import jax.numpy as jnp

    from auromat_tpu.coordinates.wcs import TanWcs
    from auromat_tpu.io import fits
    from auromat_tpu.ops.georef import DynGeorefParams, GeorefParams
    from auromat_tpu.ops.regrid import fixed_grid

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    header = fits.read_header(os.path.join(
        repo, "tests", "resources", "ISS030-E-102170_dc.wcs"))
    params = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header), altitude=110.0)
    h, w = params.height, params.width
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8).astype(np.float32)

    def burst(n):
        base = np.asarray(params.camera_pos)
        ps = [params] + [
            dataclasses.replace(params, camera_pos=tuple(
                base * (1.0 + 1e-4 * rng.standard_normal(3))))
            for _ in range(n - 1)]
        dyn = jax.device_put(DynGeorefParams.stack(ps, dtype=jnp.float32))
        imgs = jax.device_put(np.broadcast_to(img[None], (n, h, w, 3)).copy())
        return dyn, imgs

    cases = [
        ("regional", fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0), 1),
        ("global", fixed_grid(20, -89.999, 89.999, -179.999, 179.999), 8),
    ]
    # the oracle first: every other variant's counts are compared with it
    wanted = sorted((v for v in args.only.split(",") if v),
                    key=lambda v: v != "sorted")
    for label, grid, nb in cases:
        dyn, imgs = burst(nb)
        print(f"\n== {label} grid {grid.n_lat}x{grid.n_lon}, {nb} frame(s),"
              f" {nb * h * w / 1e6:.1f} M samples", flush=True)
        ref_count = None
        results = {}
        for name in wanted:
            if label != "regional" and name in REGIONAL_ONLY:
                print(f"{name:14s} not run on this grid (see REGIONAL_ONLY)")
                continue
            step = make_step(grid, h, w, name)
            t0 = time.perf_counter()
            cnt, sums = jax.block_until_ready(step(dyn, imgs))
            compile_s = time.perf_counter() - t0
            cnt = np.asarray(cnt)
            if name == "sorted":
                ref_count = cnt
            t0 = time.perf_counter()
            jax.block_until_ready(step(dyn, imgs))
            one = time.perf_counter() - t0
            iters = int(min(20, max(3, 2.0 / max(one, 1e-4))))
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                jax.block_until_ready(step(dyn, imgs))
                ts.append(time.perf_counter() - t0)
            ms = float(np.median(ts)) * 1e3
            results[name] = (ms, step)
            same = (None if ref_count is None
                    else bool(np.array_equal(cnt, ref_count)))
            print(f"{name:14s} {ms:10.3f} ms/step  {ms / nb:9.3f} ms/frame"
                  f"  (first call {compile_s:6.1f} s, {iters} iters,"
                  f" spread {min(ts)*1e3:.3f}..{max(ts)*1e3:.3f},"
                  f" counts==sorted {same})", flush=True)
            del cnt, sums
        if not results:
            continue
        best = min(results, key=lambda k: results[k][0])
        print(f"fastest on {label}: {best} ({results[best][0]:.3f} ms/step)")
        if args.trace_dir:
            for name in dict.fromkeys((best, "scatter", "sorted")):
                if name not in results:
                    continue
                step = results[name][1]
                d = os.path.join(args.trace_dir, f"{label}_{name}")
                jax.profiler.start_trace(d)
                for _ in range(3):
                    jax.block_until_ready(step(dyn, imgs))
                jax.profiler.stop_trace()
                for line, ops in _device_ops(d).items():
                    print(f"-- {name} on {label}, {line} (3 steps):")
                    for op, ms, n in ops:
                        print(f"   {ms / 3:9.3f} ms/step  x{n // 3:<4d} "
                              f"{op[:110]}")
        del dyn, imgs
    print(f"\n{smi}")


if __name__ == "__main__":
    main()
