"""Resample mappings onto regular plate-carree grids (geographic or magnetic).

High-level orchestration mirroring auromat/resample.py: pole rotation /
discontinuity shifting on the host, the hot multi-channel mean binning on
device (auromat_tpu.ops.regrid). 'nearest'/'linear'/'cubic' interpolation
methods go through scipy.griddata with outline masking, like the reference.
"""

from functools import partial as _partial

import numpy as np
import numpy.ma as ma

from auromat_tpu.backend import mean_bin_method, on_gpu
from auromat_tpu.coordinates import geodesic
from auromat_tpu.coordinates.geodesic import Location
from auromat_tpu.coordinates.transform import rotate_pole
from auromat_tpu.mapping.mapping import (
    BoundingBox,
    Mapping,
    MappingCollection,
    convert_mapping_to_sm,
    convert_sm_mapping_to_geo,
)
from auromat_tpu.ops.regrid import bin_mean, fixed_grid
from auromat_tpu.utils import host_f64_device as _host_ctx
from auromat_tpu.utils import wrap_lon_180 as _wrap_lon_np
from auromat_tpu.utils import points_inside_polygon


def plate_carree_resolution(bounding_box: BoundingBox, arcsec_per_px):
    """(lat_px_per_deg, lon_px_per_deg) approximating a spherical resolution
    at the bbox centre. Reference: auromat/resample.py:36-61."""
    deg_per_px = arcsec_per_px / 3600.0
    lat_px_per_deg = 1.0 / deg_per_px
    lat_middle = (bounding_box.latNorth + bounding_box.latSouth) / 2
    middle_left = Location(lat_middle, bounding_box.lonWest)
    middle_right = Location(lat_middle, bounding_box.lonEast)
    lon_middle_distance = geodesic.angular_distance(middle_left, middle_right)
    px = lon_middle_distance / deg_per_px
    lon_east = bounding_box.lonEast
    if bounding_box.lonWest > lon_east:
        lons = lon_east + 360 - bounding_box.lonWest
    else:
        lons = lon_east - bounding_box.lonWest
    lon_ppd = px / lons
    if not lon_ppd > 0:
        # pole-containing boxes span -180..180: the two mid-edge points
        # coincide and the measured lon width degenerates to zero. Fall
        # back to the latitude resolution — the pole path resamples in a
        # ROTATED frame anyway (rotate_pole), where the original lon
        # resolution has no special meaning.
        lon_ppd = lat_px_per_deg
    return lat_px_per_deg, lon_ppd


def resample(mapping_or_collection, px_per_deg=25, arcsec_per_px=None,
             contains_pole=None, method="mean", bin_method="auto"):
    """Resample image+elevation onto a regular lat/lon grid.

    With 'mean' binning, high target resolutions produce empty cells at low
    elevations — mask by elevation first (reference resample.py:79-84).

    :param px_per_deg: scalar or (lat, lon) pixels per degree
    :param arcsec_per_px: spherical resolution (overrides px_per_deg)
    :param method: 'mean' (device binning) | 'nearest' (host scipy KD-tree
        on CPU; on a GPU this routes to the device path below — the
        reference's recommended production method (reference
        resample.py:323-329) should not fall back to a host KD-tree when a
        device is present. Pin 'nearest_device' or 'nearest_host'
        explicitly when cross-backend cell-level determinism matters)
        | 'nearest_device' (device jump-flood Voronoi,
        ops.regrid.bin_nearest; same outline masking; ~2% of cells may pick
        a different-but-equidistant/nearby sample than the KD-tree — see
        the bin_nearest docstring) | 'linear' (host scipy
        Delaunay) | 'linear_device' (device Newton mesh inversion +
        bilinear, ops.regrid.interp_linear_structured; quad-bilinear rather
        than triangle-linear weights — identical on locally-affine data) |
        'cubic' (host scipy Clough-Tocher) | 'cubic_device' (device mesh
        inversion + Catmull-Rom bicubic)
    :param bin_method: device binning route for 'mean': 'auto' takes the
        device's route (:func:`auromat_tpu.backend.mean_bin_method`:
        scatter-add on a GPU, the exact sorted path elsewhere), or any
        ops.regrid._BIN_METHODS key explicitly. Routes sum in different
        orders: a uint8 mean sitting exactly on a .5 boundary may round
        one step differently between two routes
    :rtype: Mapping or MappingCollection
    """
    if isinstance(mapping_or_collection, MappingCollection):
        return MappingCollection(
            [resample(m, px_per_deg, arcsec_per_px, contains_pole, method,
                      bin_method)
             for m in mapping_or_collection.mappings],
            mapping_or_collection.identifier,
            mayOverlap=mapping_or_collection.mayOverlap,
        )
    mapping = mapping_or_collection
    if not isinstance(mapping, Mapping):
        raise ValueError(f"not a mapping or collection: {type(mapping)}")

    if contains_pole is None:
        contains_pole = mapping.containsPole
    if arcsec_per_px:
        px_per_deg = plate_carree_resolution(mapping.boundingBox, arcsec_per_px)
    else:
        try:
            _, _ = px_per_deg
        except TypeError:
            px_per_deg = (px_per_deg, px_per_deg)

    img = mapping.img
    img_dtype = img.dtype
    img_is_int = np.issubdtype(img_dtype, np.integer)
    if method == "nearest":
        # production default: the device jump-flood path on a GPU, host
        # scipy KD-tree elsewhere (the CPU parity suite keeps exercising
        # scipy). 'nearest_host' forces scipy on any backend.
        if on_gpu():
            method = "nearest_device"
    elif method == "nearest_host":
        method = "nearest"
    if bin_method == "auto":
        bin_method = mean_bin_method()
    img3 = img if img.ndim == 3 else img[:, :, None]
    parts = [np.asarray(img3.astype(np.float64).filled(np.nan))]
    has_elevation = mapping.elevation is not None
    if has_elevation:  # CDF/netCDF files without zenith_angle have none
        parts.append(np.asarray(mapping.elevation.filled(np.nan))[:, :, None])
    merged = np.concatenate(parts, axis=-1)
    lats, lons, lats_c, lons_c, data = _resample(
        np.asarray(mapping.latsCenter.filled(np.nan)),
        np.asarray(mapping.lonsCenter.filled(np.nan)),
        mapping.altitude, merged, lambda: mapping.outline.copy(),
        mapping.boundingBox, px_per_deg, mapping.containsDiscontinuity,
        contains_pole, method, bin_method,
    )
    img_r = data[..., :-1] if has_elevation else data
    elevation_r = data[..., -1] if has_elevation else None
    if img_is_int:
        img_r = _finalize_int_image(img_r, img_dtype)
        # mask re-derived from coordinates; fill value irrelevant
    if img3.shape[2] == 1:
        img_r = img_r[..., 0]
    return mapping.createResampled(lats, lons, lats_c, lons_c, elevation_r, img_r)


def _rotate_pole_deg(la_deg, lo_deg, angle, altitude):
    """Degrees-in/degrees-out rotate-pole about the x-axis at the emission
    altitude — the ONE wrapper behind every pole pre/post rotation here
    (mosaic compositing, the per-frame _resample pole path and its
    unrotate): the pole-mosaic grid-identity gate depends on all sites
    computing bit-identically. Host f64 regardless of the default backend
    (feeds parity-gated coordinate grids, bit-identical to the CPU goldens);
    NaN coordinates pass through as NaN."""
    with np.errstate(invalid="ignore"), _host_ctx():
        la2, lo2 = rotate_pole(
            np.deg2rad(np.asarray(la_deg, dtype=np.float64)),
            np.deg2rad(np.asarray(lo_deg, dtype=np.float64)),
            altitude, angle_deg=angle, axis=(1, 0, 0),
        )
    return np.rad2deg(np.asarray(la2)), np.rad2deg(np.asarray(lo2))


def _min_lon_interval_deg(lons):
    """Smallest directional [west, east] longitude interval covering a
    POINT set on the circle: the complement of the largest gap between
    consecutive sorted longitudes. Wrap-aware, unlike vertex min/max,
    which returns the complement interval for a footprint straddling
    +-180 (the same defect class as the reference's np.unwrap bbox merge,
    reference mapping.py:250-275). NaNs ignored."""
    x0 = np.asarray(lons, dtype=np.float64).ravel()
    x0 = x0[np.isfinite(x0)]
    if x0.size == 0:
        raise ValueError("no finite longitudes")
    key = np.mod(x0, 360.0)
    order = np.argsort(key, kind="stable")
    key_s, orig_s = key[order], x0[order]
    gaps = np.diff(np.concatenate((key_s, key_s[:1] + 360.0)))
    i = int(np.argmax(gaps))
    # return the ORIGINAL endpoint values (no mod round-trip): for a
    # compact set away from +-180 this is exactly [min(lons), max(lons)],
    # keeping the single-frame pole path bit-identical to vertex min/max

    def _w(v):
        v = float(v)
        return v if -180.0 <= v <= 180.0 else float(_wrap_lon_np(v))

    return _w(orig_s[(i + 1) % x0.size]), _w(orig_s[i])


def _finalize_int_image(img_r, img_dtype):
    """Float resampled image -> the source integer dtype.

    Cubic interpolation overshoots on sharp edges (both the host
    Clough-Tocher and the device Catmull-Rom): clamp to the integer range
    or the cast WRAPS (272 -> 16, -5 -> 251). NaN (masked) cells become 0;
    the mask is re-derived from coordinates, so the fill value is
    irrelevant."""
    with np.errstate(invalid="ignore"):
        img_r = np.round(img_r)
        info = np.iinfo(img_dtype)
        img_r = np.clip(img_r, info.min, info.max)
    return np.where(np.isnan(img_r), 0, img_r).astype(img_dtype)


def resample_mlat_mlt(mapping, **kw):
    """Resample so MLat/MLT become regular grids (reference resample.py:63-71)."""
    sm = convert_mapping_to_sm(mapping)
    sm_resampled = resample(sm, **kw)
    return convert_sm_mapping_to_geo(sm_resampled)


def mosaic(collection, px_per_deg=25, arcsec_per_px=None):
    """Compose a MappingCollection into ONE plate-carree mosaic mapping.

    Where mappings overlap (e.g. neighbouring THEMIS all-sky imagers) each
    grid cell takes the pixel of the station viewing it at the HIGHEST
    elevation — the same overlap priority the reference applies when
    drawing collections (reference draw_helpers.py:128-178 sorts the
    polygon collections by elevation so the closest-to-zenith station
    draws last), but materialized as data in one device pass
    (ops.regrid.bin_take_best: all stations' samples in a single two-key
    sort) instead of a matplotlib z-order. The reference never offers a
    mosaic *mapping* — collections must be resampled per-station and
    composited at draw time; this exceeds it the same way getSequence does
    for THEMIS.

    All mappings must carry elevation and share the emission altitude and
    image channel count. Note a collection whose members do not overlap
    produces a DISCONNECTED footprint: ``outline``/``boundingBox``/
    ``containsPole`` of the result follow the largest connected component
    only (the reference's single-contour outline semantics,
    auromat/utils.py:76-151) — keep the MappingCollection and merge
    per-member boxes when the full extent matters. Returns a single :class:`Mapping` (camera_pos is
    NaN — a mosaic has no single camera; photoTime/identifier come from
    the collection). Pole-containing collections compose in the rotated
    frame (the per-frame rotate-pole machinery) and return an
    irregular-grid mapping; antimeridian-crossing ones use the +180-deg
    lon shift.

    :param collection: MappingCollection or list of Mappings
    """
    mappings = (collection.mappings
                if isinstance(collection, MappingCollection) else list(collection))
    identifier = (getattr(collection, "identifier", None) or "collection")
    if not mappings:
        raise ValueError("empty collection")
    for m in mappings:
        if m.elevation is None:
            raise ValueError(
                f"mosaic needs elevation for overlap priority; {m.identifier}"
                " has none")
    altitude = mappings[0].altitude
    if any(abs(m.altitude - altitude) > 1e-9 for m in mappings):
        raise ValueError("mappings map different emission altitudes")
    n_ch = mappings[0].img.shape[2] if mappings[0].img.ndim == 3 else 1
    bbox = BoundingBox.mergedBoundingBoxes(m.boundingBox for m in mappings)
    # pole-containing collections compose in a ROTATED frame — the same
    # rotate-pole pre/post the per-frame _resample runs (reference
    # resample.py:176-201 semantics); the returned mapping carries the
    # unrotated (irregular) coordinate grids. A discontinuity without a
    # pole keeps the cheaper +180-deg lon shift.
    contains_pole = any(m.containsPole for m in mappings)
    shift = bbox.containsDiscontinuity and not contains_pole
    if arcsec_per_px:
        px_per_deg = plate_carree_resolution(bbox, arcsec_per_px)
    try:
        _, _ = px_per_deg
    except TypeError:
        px_per_deg = (px_per_deg, px_per_deg)

    _rot = _partial(_rotate_pole_deg, altitude=altitude)

    lats_l, lons_l, data_l = [], [], []
    img_dtype = None
    rot_boxes = []
    for m in mappings:
        img = m.img
        img3 = img if img.ndim == 3 else img[:, :, None]
        if img3.shape[2] != n_ch:
            raise ValueError("mappings have different image channel counts")
        if img_dtype is None:
            img_dtype = img3.dtype
        elif img3.dtype != img_dtype:
            # a silent cast to the first dtype would wrap out-of-range
            # values (uint16 THEMIS counts into a uint8 mosaic)
            raise ValueError(
                f"mappings have different image dtypes: {img_dtype} vs "
                f"{img3.dtype}")
        la = np.asarray(m.latsCenter.filled(np.nan)).ravel()
        lo = np.asarray(m.lonsCenter.filled(np.nan)).ravel()
        if contains_pole:
            la, lo = _rot(la, lo, 90.0)
            ola, olo = _rot(m.outline[:, 0], m.outline[:, 1], 90.0)
            # per-member extent must be wrap-aware IN THE ROTATED FRAME:
            # a member that does not itself contain a geographic pole can
            # still straddle the rotated antimeridian (vertex min/max
            # would then return the complement interval and its samples
            # would silently fall outside the grid), or even surround a
            # rotated pole (no single lon interval covers it — refuse).
            # The per-frame pole path needs none of this: one frame
            # containing the geographic pole rotates to a compact
            # equatorial blob.
            if geodesic.contains_or_crosses_pole(
                    np.stack([ola, olo], axis=1)):
                raise ValueError(
                    f"{m.identifier}: footprint covers the rotated-frame "
                    "pole — the collection spans too much of the sphere "
                    "to compose in one rotated plate-carree frame; "
                    "mosaic such members separately")
            w, e = _min_lon_interval_deg(olo)
            rot_boxes.append(BoundingBox(float(ola.min()), w,
                                         float(ola.max()), e))
        elif shift:
            lo = _wrap_lon_np(lo + 180.0)
        el = np.asarray(m.elevation.filled(np.nan)).ravel()
        im = np.asarray(img3.astype(np.float32).filled(np.nan)).reshape(-1, n_ch)
        lats_l.append(la)
        lons_l.append(lo)
        data_l.append(np.concatenate([im, el[:, None]], axis=-1))
    lats = np.concatenate(lats_l)
    lons = np.concatenate(lons_l)
    data = np.concatenate(data_l, axis=0)

    rot_shift = False
    if contains_pole:
        rot_bbox = BoundingBox.mergedBoundingBoxes(rot_boxes)
        lat_min, lat_max = rot_bbox.latSouth, rot_bbox.latNorth
        lon_min, lon_max = rot_bbox.lonWest, rot_bbox.lonEast
        # merged interval crosses +-180 in the rotated frame: compose in
        # the +180-shifted rotated frame (the same convention as the
        # non-pole discontinuity path; unshifted before unrotation below)
        rot_shift = lon_min > lon_max
        if rot_shift:
            lons = _wrap_lon_np(lons + 180.0)
            lon_min = _wrap_lon_np(lon_min + 180.0)
            lon_max = _wrap_lon_np(lon_max + 180.0)
            if lon_min > lon_max:
                # near-full-circle coverage: no shift can unwrap it —
                # grid the whole circle rather than mis-clip
                lon_min, lon_max = -180.0, 180.0
    else:
        lat_min, lat_max = bbox.latSouth, bbox.latNorth
        lon_min, lon_max = ((bbox.lonWest, bbox.lonEast) if not shift else
                            (_wrap_lon_np(bbox.lonWest + 180.0),
                             _wrap_lon_np(bbox.lonEast + 180.0)))
    from auromat_tpu.ops.regrid import bin_take_best

    grid = fixed_grid(px_per_deg, float(lat_min), float(lat_max),
                      float(lon_min), float(lon_max))
    best, _ = bin_take_best(grid, lats, lons, -data[:, -1], data)
    best = np.asarray(best, dtype=np.float64)
    img_r, elev_r = best[..., :n_ch], best[..., n_ch]

    if np.issubdtype(img_dtype, np.integer):
        img_r = _finalize_int_image(img_r, img_dtype)
    if n_ch == 1:
        img_r = img_r[..., 0]
    if contains_pole:
        # unrotate the regular rotated-frame grid back to true lat/lon:
        # the product is a valid (irregular-grid) Mapping, like the
        # per-frame pole path (reference resample.py:195-201)
        lat_grid, lon_grid = grid.corner_grids()
        lat_grid_c, lon_grid_c = grid.center_grids()
        if rot_shift:
            lon_grid = _wrap_lon_np(lon_grid + 180.0)
            lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
        shp, shpc = lat_grid.shape, lat_grid_c.shape
        lat_grid, lon_grid = (a.reshape(shp) for a in _rot(
            lat_grid.ravel(), lon_grid.ravel(), -90.0))
        lat_grid_c, lon_grid_c = (a.reshape(shpc) for a in _rot(
            lat_grid_c.ravel(), lon_grid_c.ravel(), -90.0))
        return Mapping(
            lat_grid, lon_grid, lat_grid_c, lon_grid_c, elev_r, altitude,
            img_r, np.full(3, np.nan), mappings[0].photoTime,
            f"{identifier}.mosaic",
        )
    return grid_mapping(grid, img_r, elev_r, altitude,
                        mappings[0].photoTime, f"{identifier}.mosaic",
                        shift=shift)


def grid_mapping(grid, img_r, elev_r, altitude, photo_time, identifier,
                 shift=False):
    """Assemble a mosaic :class:`Mapping` from a plate-carree
    :class:`~auromat_tpu.ops.regrid.GridSpec` and finalized per-cell
    channels — the shared tail of :func:`mosaic` and the CLI
    ``--mosaic`` path (camera_pos is NaN: a mosaic has no single camera).
    ``shift=True`` unwraps +180-deg-shifted longitudes (the
    discontinuity-handling convention of :func:`resample`)."""
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()
    if shift:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
    return Mapping(
        lat_grid, lon_grid, lat_grid_c, lon_grid_c, elev_r, altitude, img_r,
        np.full(3, np.nan), photo_time, identifier,
    )


def _resample(lats_center, lons_center, altitude, data, outline_fn, bbox,
              px_per_deg, contains_discontinuity, contains_pole, method,
              bin_method="sorted"):
    lat_min, lat_max = bbox.latSouth, bbox.latNorth
    lon_min, lon_max = bbox.lonWest, bbox.lonEast

    if contains_pole:
        outline = outline_fn()
        outline[:, 0], outline[:, 1] = _rotate_pole_deg(
            outline[:, 0], outline[:, 1], 90.0, altitude)
        lat_min, lat_max = outline[:, 0].min(), outline[:, 0].max()
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        la, lo = _rotate_pole_deg(lats_center.ravel(), lons_center.ravel(),
                                  90.0, altitude)
        lats_center = la.reshape(lats_center.shape)
        lons_center = lo.reshape(lons_center.shape)
        outline_fn = lambda: outline
    elif contains_discontinuity:
        outline = outline_fn()
        outline[:, 1] = _wrap_lon_np(outline[:, 1] + 180.0)
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        lons_center = _wrap_lon_np(lons_center + 180.0)
        outline_fn = lambda: outline

    grid = fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max)
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()

    if method == "mean":
        _, data_r = bin_mean(grid, lats_center, lons_center, data,
                             method=bin_method)
        data_r = np.asarray(data_r)
    elif method in ("nearest", "nearest_device", "linear", "linear_device",
                    "cubic", "cubic_device"):
        if method == "nearest_device":
            # device nearest: per-bin seeding + jump-flood Voronoi on
            # device (ops.regrid.bin_nearest) — the device path for the
            # reference's *recommended* production method on fine grids
            # (reference resample.py:323-329)
            from auromat_tpu.ops.regrid import bin_nearest

            data_r, _ = bin_nearest(grid, lats_center, lons_center, data)
            data_r = np.asarray(data_r).astype(np.float64)
        elif method in ("linear_device", "cubic_device"):
            # device linear/cubic: Newton-invert the smooth (h, w)
            # pixel->lat/lon mesh per target cell and sample bilinearly /
            # Catmull-Rom bicubically — no host Delaunay
            # (ops.regrid.interp_{linear,cubic}_structured)
            from auromat_tpu.ops.regrid import (interp_cubic_structured,
                                                interp_linear_structured)

            fn = (interp_linear_structured if method == "linear_device"
                  else interp_cubic_structured)
            data_r, _ = fn(grid, lats_center, lons_center, data)
            data_r = np.asarray(data_r).astype(np.float64)
        else:
            import scipy.interpolate

            ok = ~np.isnan(lats_center.ravel())
            pts = (lats_center.ravel()[ok], lons_center.ravel()[ok])
            vals = data.reshape(-1, data.shape[-1])[ok]
            data_r = scipy.interpolate.griddata(
                pts, vals,
                (grid.lat_centers[:, None], grid.lon_centers[None, :]),
                method=method,
            )
        # mask cells outside the (concave) outline — griddata only clips to
        # the convex hull (reference resample.py:248-259)
        outline = outline_fn()
        flat = np.stack([lat_grid.ravel(), lon_grid.ravel()], axis=-1)
        outside = ~points_inside_polygon(flat, outline).reshape(lat_grid.shape)
        cell_outside = (
            outside[:-1, :-1] | outside[1:, :-1] | outside[:-1, 1:] | outside[1:, 1:]
        )
        data_r[cell_outside] = np.nan
    else:
        raise NotImplementedError(method)

    if contains_pole:
        def unrotate(la, lo):
            la2, lo2 = _rotate_pole_deg(la.ravel(), lo.ravel(), -90.0,
                                        altitude)
            return la2.reshape(la.shape), lo2.reshape(lo.shape)

        lat_grid, lon_grid = unrotate(lat_grid, lon_grid)
        lat_grid_c, lon_grid_c = unrotate(lat_grid_c, lon_grid_c)
    elif contains_discontinuity:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)

    return lat_grid, lon_grid, lat_grid_c, lon_grid_c, data_r


def ResampleProvider(provider, **kw):
    """Wrap a provider so every mapping is resampled."""
    import copy

    fn = _partial(resample, **kw)
    provider = copy.copy(provider)
    orig_get, orig_get_by_id, orig_seq = provider.get, provider.getById, provider.getSequence
    provider.get = lambda *a, **k: fn(orig_get(*a, **k))
    provider.getById = lambda *a, **k: fn(orig_get_by_id(*a, **k))
    provider.getSequence = lambda *a, **k: map(fn, orig_seq(*a, **k))
    # batched-pipeline dispatch probes hasattr(provider, "getSequenceBatched")
    # (cli/convert.py): wrap it too, or batched consumers would silently get
    # UNRESAMPLED mappings from the copied provider
    if hasattr(provider, "getSequenceBatched"):
        orig_batched = provider.getSequenceBatched
        provider.getSequenceBatched = lambda *a, **k: map(fn, orig_batched(*a, **k))
    return provider
