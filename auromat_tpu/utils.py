"""Generic geometry/image utilities (host side).

Mirrors the parts of auromat/utils.py the data model needs: binary-image
outline extraction, convex hulls, polygon area/centroid, point-in-polygon.
"""

import numpy as np


def host_f64_device():
    """Context pinning jax math to the host CPU backend when it is not the
    default backend.

    Host-side per-frame math (mapping lazies, ASI calibration reprojection,
    pole rotation) is small, eager and latency-bound, so the host CPU is
    the fast placement, and its float64 results stay bit-identical to the
    CPU-gated goldens whatever the accelerator. No-op when CPU already is
    the default, or when no CPU backend exists (``jax_platforms`` pinned to
    an accelerator alone — the convert CLI therefore selects "cuda,cpu",
    not bare "cuda"). Device-resident pipelines (ops.georef/georegrid,
    parallel.*) manage their own placement and never route through this."""
    import contextlib

    import jax

    if jax.default_backend() != "cpu":
        try:
            return jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:
            pass
    return contextlib.nullcontext()


def vector_lengths(vectors, axis=-1):
    vectors = np.asarray(vectors)
    return np.sqrt((vectors * vectors).sum(axis=axis))


def unit_vectors(vectors, axis=-1):
    vectors = np.asarray(vectors)
    lengths = np.expand_dims(vector_lengths(vectors, axis), axis)
    return vectors / lengths


def angle_between(v1, v2, axis=-1):
    """Angles in radians between unit-vector arrays, in [0, pi]."""
    dot = np.clip(np.sum(np.asarray(v1) * np.asarray(v2), axis=axis), -1, 1)
    return np.arccos(dot)


def signed_angle_between(v1, v2):
    """Signed angles in radians between 2D vector arrays, in [-pi, pi]."""
    v1, v2 = np.asarray(v1), np.asarray(v2)
    return np.arctan2(
        v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0],
        v1[:, 0] * v2[:, 0] + v1[:, 1] * v2[:, 1],
    )


def points_inside_polygon(points, polygon):
    """For each (n,2) point, whether it lies inside the unclosed polygon."""
    import matplotlib.path

    return matplotlib.path.Path(np.asarray(polygon)).contains_points(np.asarray(points))


def outline(im):
    """Outline of a binary image (True = inside), clockwise, as (n, 2) x,y.

    Works for concave shapes; border-touching regions are preserved by
    padding (reference: auromat/utils.py:76-151, via OpenCV here).
    """
    import cv2

    padded = np.zeros((im.shape[0] + 2, im.shape[1] + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = np.asarray(im, dtype=bool)
    # CHAIN_APPROX_NONE: simplification would turn concave runs convex
    contours, _ = cv2.findContours(padded, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    if len(contours) == 0:
        raise ValueError("binary image contains no region")
    if len(contours) > 1:
        areas = [cv2.contourArea(c) for c in contours]
        contour = contours[int(np.argmax(areas))]
    else:
        contour = contours[0]
    return np.asarray(contour).reshape(-1, 2) - 1


def convex_hull(points):
    """Convex hull of (n, 2) integer points, as ordered (m, 2) array."""
    from scipy.spatial import ConvexHull

    points = np.asarray(points)
    hull = ConvexHull(points)
    return points[hull.vertices]


def polygon_area(poly, signed=False):
    """Area of an unclosed polygon via the shoelace formula."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    a = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return a if signed else abs(a)


def polygon_centroid(poly):
    """Centroid of an unclosed polygon (planar shoelace centroid)."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = 0.5 * cross.sum()
    if a == 0:
        return float(x.mean()), float(y.mean())
    cx = ((x + xn) * cross).sum() / (6 * a)
    cy = ((y + yn) * cross).sum() / (6 * a)
    return float(cx), float(cy)


def find_nearest(a, value):
    """Index of the element of sorted array ``a`` nearest to ``value``."""
    a = np.asarray(a)
    idx = int(np.searchsorted(a, value))
    if idx == 0:
        return 0
    if idx >= len(a):
        return len(a) - 1
    return idx if abs(a[idx] - value) < abs(a[idx - 1] - value) else idx - 1


def without_consecutive_duplicates(points):
    """Drop consecutive duplicate rows of an (n, d) array (reference
    utils.withoutConsecutiveDuplicates, used on traced outlines)."""
    points = np.asarray(points)
    if len(points) < 2:
        return points
    keep = np.ones(len(points), dtype=bool)
    keep[1:] = (points[1:] != points[:-1]).any(axis=1)
    return points[keep]


def wrap_lon_180(lon):
    """Wrap degrees into [-180, 180), host-side numpy f64.

    The jax-based transform.wrap_longitude would run per-frame grid wraps
    on the DEFAULT backend — an eager device roundtrip per call under an
    accelerator default. Host grid math stays numpy (CLAUDE.md convention).
    """
    return (np.asarray(lon, dtype=np.float64) + 180.0) % 360.0 - 180.0
