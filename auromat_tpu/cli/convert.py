"""auromat-tpu-convert: batch-convert cached mapping data to CDF/netCDF.

Mirrors auromat/cli/convert.py:148-218: detects the source type of a data
folder (api.json -> ISS archive, thg_l1_* -> THEMIS, cal.txt -> MIRACLE,
image+wcs pairs -> spacecraft), optionally resamples onto a geographic or
magnetic grid, and exports each mapping with skip/overwrite logic. This is
the throughput-critical production loop (SURVEY.md call stack 3.3).
"""

import argparse
import fnmatch
import os
import sys


def detect_source_type(folder):
    files = os.listdir(folder)
    if "api.json" in files:
        return "iss"
    if fnmatch.filter(files, "thg_l1_*"):
        return "themis"
    if "cal.txt" in files:
        return "miracle"
    if fnmatch.filter(files, "*.wcs"):
        return "spacecraft"
    raise ValueError(f"cannot detect mapping source type in {folder}")


def make_provider(source_type, folder, altitude, fast_center=True):
    if source_type == "iss":
        from auromat_tpu.mapping.iss import ISSMappingProvider

        return ISSMappingProvider(folder, altitude=altitude, offline=False,
                                  fastCenterCalculation=fast_center)
    if source_type == "themis":
        from auromat_tpu.mapping.themis import ThemisMappingProvider

        return ThemisMappingProvider(folder, folder, altitude=altitude, offline=True)
    if source_type == "miracle":
        from auromat_tpu.mapping.miracle import MIRACLEMappingProvider

        return MIRACLEMappingProvider(folder, altitude=altitude)
    if source_type == "spacecraft":
        from auromat_tpu.mapping.spacecraft import SpacecraftMappingProvider

        return SpacecraftMappingProvider(folder, folder, altitude=altitude,
                                         fast_center=fast_center)
    raise ValueError(source_type)


from auromat_tpu.timeutil import parse_cli_date as _parse_date


def build_parser():
    p = argparse.ArgumentParser(
        prog="auromat-tpu-convert",
        description="convert cached mapping data to CDF/netCDF files",
    )
    src = p.add_argument_group("input")
    src.add_argument("folder", help="data folder (source type auto-detected)")
    src.add_argument("--start", type=_parse_date, help="sequence start date")
    src.add_argument("--end", type=_parse_date, help="sequence end date (inclusive)")
    src.add_argument("--altitude", type=float, default=110,
                     help="emission altitude in km (default 110)")

    proc = p.add_argument_group("processing")
    proc.add_argument("--grid", choices=["none", "geo", "mag"], default="none",
                      help="resample onto a geographic or magnetic grid")
    proc.add_argument("--arcsecperpx", type=float, default=100,
                      help="grid resolution in arcsec/px (default 100)")
    proc.add_argument("--min-elevation", type=float, default=None,
                      help="mask pixels below this elevation before resampling")
    proc.add_argument("--precision", choices=["float64", "float32"],
                      default="float64", help="device compute precision")
    proc.add_argument("--batched", type=int, default=0, metavar="N",
                      help="georeference N frames per device call (the "
                           "batched vmap pipeline; f32 device precision — "
                           "spacecraft sources only; 0 = per-frame float64)")
    proc.add_argument("--mosaic", type=float, default=None, metavar="DEG",
                      help="mosaic the WHOLE sequence into one plate-"
                           "carree grid at DEG degrees/cell (e.g. 0.05 = "
                           "the global production grid) and write a single "
                           "file: provider bursts stream through the grid-"
                           "sharded device mosaic (parallel.mosaic_"
                           "sequence); spacecraft sources only")
    proc.add_argument("--mosaic-extent", type=float, nargs=4, default=None,
                      metavar=("S", "N", "W", "E"),
                      help="restrict the --mosaic grid to this lat/lon box "
                           "(default: global)")
    proc.add_argument("--platform", choices=["cpu", "gpu", "default"],
                      default="cpu",
                      help="jax backend; cpu (default) runs the float64 "
                           "parity path — single-frame conversion is "
                           "host-latency-bound, the GPU path is for batched "
                           "sequence processing (auromat_tpu.parallel); a "
                           "platform that fails to initialize is an error")

    out = p.add_argument_group("output")
    out.add_argument("--format", choices=["cdf", "netcdf"], default="cdf")
    out.add_argument("--out", default=None, help="output folder (default: input)")
    out.add_argument("--overwrite", action="store_true",
                     help="overwrite existing output files")
    out.add_argument("--without-bounds", action="store_true",
                     help="omit pixel-corner coordinates")
    out.add_argument("--without-mag", action="store_true",
                     help="omit MLat/MLT coordinates")
    return p


def convert_mapping(mapping, args, out_folder):
    from auromat_tpu.resample import resample, resample_mlat_mlt

    # skip-existing BEFORE the expensive mask+resample (the identifier is
    # unchanged by resampling) — resume over a large sequence must not pay
    # the device work for already-written frames
    ext = ".cdf" if args.format == "cdf" else ".nc"
    out_path = os.path.join(out_folder, f"{mapping.identifier}{ext}")
    if os.path.exists(out_path) and not args.overwrite:
        print(f"skipping {out_path} (exists)")
        return out_path
    if args.min_elevation is not None:
        mapping = mapping.maskedByElevation(args.min_elevation)
    if args.grid == "geo":
        mapping = resample(mapping, arcsec_per_px=args.arcsecperpx, method="mean")
    elif args.grid == "mag":
        mapping = resample_mlat_mlt(mapping, arcsec_per_px=args.arcsecperpx,
                                    method="mean")
    if args.format == "cdf":
        from auromat_tpu.export import cdf as writer
    else:
        from auromat_tpu.export import netcdf as writer
    writer.write(out_path, mapping, includeBounds=not args.without_bounds,
                 includeMagCoords=not args.without_mag)
    print(f"wrote {out_path}")
    return out_path


def convert_mosaic(provider, args, out_folder):
    """Stream the whole sequence through the grid-sharded device mosaic
    (parallel.mosaic_sequence) and write ONE file.

    The reference's convert loop writes one file per frame
    (auromat/cli/convert.py:176-218); a sequence-level mosaic product has
    no reference counterpart — it exists here because the sharded step
    makes it a single device pipeline (BASELINE config 5 at the CLI).
    """
    import numpy as np

    from auromat_tpu.ops.regrid import fixed_grid
    from auromat_tpu.parallel import make_mesh, mosaic_sequence
    from auromat_tpu.resample import _finalize_int_image, grid_mapping

    if not hasattr(provider, "iterParamBursts"):
        print("error: --mosaic needs a spacecraft source (image+wcs pairs)",
              file=sys.stderr)
        return None
    # validate the cheap host-side arguments BEFORE the skip-existing
    # early-return: an invalid invocation must fail even when the output
    # already exists
    if not args.mosaic > 0:
        print(f"error: --mosaic must be a positive deg/cell size, got "
              f"{args.mosaic}", file=sys.stderr)
        return None
    if args.mosaic_extent is not None:
        s, n, w, e = args.mosaic_extent
        if not (-90.0 <= s < n <= 90.0) or not (-180.0 <= w < e <= 180.0):
            print("error: --mosaic-extent wants SOUTH NORTH WEST EAST with "
                  f"south < north and west < east (no antimeridian "
                  f"crossing); got {args.mosaic_extent}", file=sys.stderr)
            return None
    # skip-existing next (identifier derives from the folder alone):
    # resume must not pay a device compile + the full sequence stream
    identifier = (os.path.basename(os.path.normpath(args.folder))
                  + ".mosaic")
    ext = ".cdf" if args.format == "cdf" else ".nc"
    out_path = os.path.join(out_folder, f"{identifier}{ext}")
    if os.path.exists(out_path) and not args.overwrite:
        print(f"skipping {out_path} (exists)")
        return out_path
    if args.mosaic_extent is None:
        # global; epsilon keeps the inclusive +-90/+-180 edges out of the
        # open-ended last bin (same shape as the config-5 grid)
        s, n, w, e = -89.999, 89.999, -179.999, 179.999
    grid = fixed_grid(1.0 / args.mosaic, s, n, w, e)
    # frames data-parallel over every device; the GRID is row-band sharded
    # over the whole mesh either way, so sp=1 keeps arbitrary frame
    # heights shardable
    mesh = make_mesh(sp=1)
    dp = mesh.shape["dp"]
    batch = max(args.batched or 8, dp)
    batch = -(-batch // dp) * dp
    from auromat_tpu.backend import mean_bin_method

    bin_method = mean_bin_method()
    print(f"mosaicking onto a {grid.n_lat} x {grid.n_lon} grid "
          f"({args.mosaic} deg/cell), {dp}-device mesh, burst size {batch}, "
          f"{bin_method} binning")
    # the product's time stamp = first frame ACTUALLY included (range
    # ignores --start/--end and could name an excluded frame)
    first, _ = provider.timeRange(args.start, args.end)
    if first is None:
        print("error: no timed frames in the requested range",
              file=sys.stderr)
        return None
    count, means = mosaic_sequence(
        mesh, grid, provider.iterParamBursts(args.start, args.end,
                                             batch=batch), batch=batch,
        bin_method=bin_method, min_elevation=args.min_elevation)
    count = np.asarray(count)[: grid.n_lat]
    means = np.asarray(means, dtype=np.float64)[: grid.n_lat]
    img_r = _finalize_int_image(means[..., :3], np.uint8)
    elev_r = means[..., 3]
    mapping = grid_mapping(grid, img_r, elev_r, provider.altitude, first,
                           identifier)
    if args.format == "cdf":
        from auromat_tpu.export import cdf as writer
    else:
        from auromat_tpu.export import netcdf as writer
    writer.write(out_path, mapping, includeBounds=not args.without_bounds,
                 includeMagCoords=not args.without_mag)
    print(f"wrote {out_path} ({int((count > 0).sum())} occupied cells)")
    return out_path


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.platform != "default":
        import jax

        # keep the CPU backend registered alongside an accelerator (first
        # entry = default): host-side f64 math (mapping lazies, ASI
        # reprojection, pole rotation) pins itself to the CPU device via
        # utils.host_f64_device, which needs jax.devices("cpu") to exist
        # "cuda", not the "gpu" alias: jax expands "gpu" to cuda AND rocm
        # and fails when either plugin is missing
        platforms = "cpu" if args.platform == "cpu" else "cuda,cpu"
        # a conversion that silently ran on another backend would not be
        # the one asked for: an unavailable platform (or a process whose
        # backend is already initialized with another one) is an error
        try:
            jax.config.update("jax_platforms", platforms)
            got = jax.devices()[0].platform  # init now
        except RuntimeError as e:
            print(f"error: platform {args.platform!r} failed to "
                  f"initialize: {e}", file=sys.stderr)
            return 2
        if got != args.platform:
            print(f"error: platform {args.platform!r} requested, but JAX "
                  f"runs on {got!r}", file=sys.stderr)
            return 2
    source_type = detect_source_type(args.folder)
    print(f"detected source type: {source_type}")
    provider = make_provider(source_type, args.folder, args.altitude)
    if args.precision == "float32" and hasattr(provider, "dtype"):
        import jax.numpy as jnp

        provider.dtype = jnp.float32
    out_folder = args.out or args.folder
    os.makedirs(out_folder, exist_ok=True)

    if args.mosaic is not None:
        return 0 if convert_mosaic(provider, args, out_folder) else 1

    if args.batched and hasattr(provider, "getSequenceBatched"):
        seq = provider.getSequenceBatched(args.start, args.end,
                                          batch=args.batched,
                                          with_mlatmlt=not args.without_mag)
    else:
        if args.batched:
            print("warning: --batched unsupported for this source; "
                  "using the per-frame path", file=sys.stderr)
        seq = provider.getSequence(args.start, args.end)

    count = 0
    for mapping in seq:
        from auromat_tpu.mapping.mapping import MappingCollection

        mappings = mapping.mappings if isinstance(mapping, MappingCollection) else [mapping]
        for m in mappings:
            convert_mapping(m, args, out_folder)
            count += 1
    print(f"converted {count} mappings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
