"""Coordinate representation conversions as pure jax.numpy device code.

Everything here is dtype-polymorphic, shape-polymorphic, jit/vmap-safe and
free of Python control flow on traced values. The reference's numpy/numexpr
twin implementations (auromat/coordinates/transform.py:38-299) collapse to
single jnp implementations — XLA fusion plays the role numexpr played.

High-level date-dependent conversions (J2000<->GEO/SM) take a pre-computed
3x3 rotation matrix from `auromat_tpu.coordinates.frames` (host side) so the
device function stays pure.
"""

import jax
import jax.numpy as jnp
import numpy as np

from auromat_tpu.constants import WGS84_A, WGS84_B


def spherical_to_cartesian(r, lat, lon):
    """(r, lat, lon) -> (x, y, z). lat/lon in radians; r may be None (unit sphere).

    Reference semantics: auromat/coordinates/transform.py:89-102.
    """
    cos_lat = jnp.cos(lat)
    x = cos_lat * jnp.cos(lon)
    y = cos_lat * jnp.sin(lon)
    z = jnp.sin(lat)
    if r is not None:
        x, y, z = r * x, r * y, r * z
    return x, y, z


def cartesian_to_spherical(x, y, z, with_radius=True):
    """(x, y, z) -> (r, lat, lon) or (lat, lon). Radians.

    Reference semantics: auromat/coordinates/transform.py:104-154.
    """
    s2 = x * x + y * y
    s = jnp.sqrt(s2)
    lat = jnp.arctan2(z, s)
    lon = jnp.arctan2(y, x)
    if with_radius:
        r = jnp.sqrt(s2 + z * z)
        return r, lat, lon
    return lat, lon


def geodetic_to_ecef(lat, lon, h, a=WGS84_A, b=WGS84_B):
    """Geodetic (radians, height in same unit as a/b) -> ECEF cartesian.

    Reference: auromat/coordinates/transform.py:156-178.
    """
    e2 = (a * a - b * b) / (a * a)
    sin_lat = jnp.sin(lat)
    n = a / jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)
    cos_lat = jnp.cos(lat)
    nh = (n + h) * cos_lat
    x = nh * jnp.cos(lon)
    y = nh * jnp.sin(lon)
    z = (n * (1.0 - e2) + h) * sin_lat
    return x, y, z


def geodetic_to_ecef_zero(lat, lon, a=WGS84_A, b=WGS84_B):
    """:func:`geodetic_to_ecef` with h=0 (reference: transform.py:180-197)."""
    e2 = (a * a - b * b) / (a * a)
    sin_lat = jnp.sin(lat)
    n = a / jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)
    nc = n * jnp.cos(lat)
    return nc * jnp.cos(lon), nc * jnp.sin(lon), n * (1.0 - e2) * sin_lat


def ecef_to_geodetic(x, y, z, a=WGS84_A, b=WGS84_B):
    """ECEF -> geodetic (lat, lon) in radians via Bowring's 1985 method.

    Accuracy >= 11 decimal digits in degrees for float64 inputs
    (reference: auromat/coordinates/transform.py:199-230).

    Exactly on the rotation axis (x == y == 0) the method divides 0/0 and
    returns NaN lat (same as the reference); callers with possibly-polar
    points should special-case them. Points merely *near* the pole are fine.
    """
    e2 = (a * a - b * b) / (a * a)
    d = (a * a - b * b) / b
    p2 = x * x + y * y
    p = jnp.sqrt(p2)
    r = jnp.sqrt(p2 + z * z)
    tu = b * z * (1.0 + d / r) / (a * p)
    tu2 = tu * tu
    cu = 1.0 / jnp.sqrt(1.0 + tu2)
    cu3 = cu * cu * cu
    # NOTE: reference computes (1/sqrt(1+tu2))**3 via pow for accuracy
    # (transform.py:279); with float64 cu*cu*cu is equivalent to <1 ulp
    # of the final angle and is cheaper on the VPU.
    su3 = cu3 * tu2 * tu
    tp = (z + d * su3) / (p - e2 * a * cu3)
    lat = jnp.arctan(tp)
    lon = jnp.arctan2(y, x)
    return lat, lon


def apply_rotation(mat, x, y, z):
    """Apply a single 3x3 rotation to component arrays of any shape."""
    mat = jnp.asarray(mat)
    xr = mat[0, 0] * x + mat[0, 1] * y + mat[0, 2] * z
    yr = mat[1, 0] * x + mat[1, 1] * y + mat[1, 2] * z
    zr = mat[2, 0] * x + mat[2, 1] * y + mat[2, 2] * z
    return xr, yr, zr


def apply_rotation_vecs(mat, vecs):
    """Apply a 3x3 rotation to an (..., 3) array of vectors."""
    # HIGHEST: a GPU otherwise may run an f32 einsum in TF32 (~3 decimal
    # digits) — fatal for the <=11-decimal geodetic accuracy contract
    return jnp.einsum("ij,...j->...i", jnp.asarray(mat), vecs,
                      precision=jax.lax.Precision.HIGHEST)


def rotate_pole(lats, lons, altitude, angle_deg=90.0, axis=(1, 0, 0), a=WGS84_A, b=WGS84_B):
    """Rotate geodetic coordinates rigidly around a coordinate axis.

    Used to move data away from a pole before plate-carree gridding
    (reference: auromat/coordinates/transform.py:301-322).

    :param lats, lons: radians, any shape
    :param altitude: km
    :returns: (lats, lons) in radians
    """
    x, y, z = geodetic_to_ecef(lats, lons, altitude, a, b)
    alpha = np.deg2rad(angle_deg)
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(alpha), np.sin(alpha)
    ux, uy, uz = axis
    rot = (
        c * np.eye(3)
        + (1 - c) * np.outer(axis, axis)
        + s * np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]])
    )
    xr, yr, zr = apply_rotation(rot, x, y, z)
    return ecef_to_geodetic(xr, yr, zr, a, b)


def sm_lon_to_mlt(smlon_deg):
    """Solar-magnetic longitude (deg) -> magnetic local time (hours).

    Reference: auromat/coordinates/transform.py:373-386.
    """
    return smlon_deg * (24.0 / 360.0) + 12.0


def mlt_to_sm_lon(mlt_hours):
    """Magnetic local time (hours) -> solar-magnetic longitude (deg).

    Reference: auromat/coordinates/transform.py:388-401.
    """
    return (mlt_hours - 12.0) / (24.0 / 360.0)


def j2000_to_latlon(vecs, mat_j2000_to_geo, a=WGS84_A, b=WGS84_B):
    """Cartesian J2000 vectors (..., 3) -> geodetic (lat, lon) in degrees.

    ``mat_j2000_to_geo`` comes from frames.FrameMatrices (host).
    Reference: auromat/coordinates/transform.py:324-343.
    """
    geo = apply_rotation_vecs(mat_j2000_to_geo, vecs)
    lat, lon = ecef_to_geodetic(geo[..., 0], geo[..., 1], geo[..., 2], a, b)
    return jnp.rad2deg(lat), jnp.rad2deg(lon)


def latlon_to_j2000(lat_deg, lon_deg, h, mat_j2000_to_geo, a=WGS84_A, b=WGS84_B):
    """Geodetic degrees + height -> cartesian J2000 (..., 3).

    Reference: auromat/coordinates/transform.py:345-371.
    """
    x, y, z = geodetic_to_ecef(jnp.deg2rad(lat_deg), jnp.deg2rad(lon_deg), h, a, b)
    geo = jnp.stack([x, y, z], axis=-1)
    return apply_rotation_vecs(jnp.asarray(mat_j2000_to_geo).T, geo)


def _sm_vecs_to_mlat_mlt(sm):
    lat, lon = cartesian_to_spherical(sm[..., 0], sm[..., 1], sm[..., 2], with_radius=False)
    mlat = jnp.rad2deg(lat)
    mlt = sm_lon_to_mlt(jnp.rad2deg(lon))
    return mlat, mlt


def j2000_to_mlat_mlt(vecs, mat_j2000_to_sm):
    """Cartesian J2000 (..., 3) -> (MLat deg, MLT hours).

    Reference: auromat/coordinates/transform.py:403-430.
    """
    return _sm_vecs_to_mlat_mlt(apply_rotation_vecs(mat_j2000_to_sm, vecs))


def geo_to_mlat_mlt(vecs, mat_geo_to_sm):
    """ECEF (..., 3) -> (MLat deg, MLT hours).

    Reference: auromat/coordinates/transform.py:432-459.
    """
    return _sm_vecs_to_mlat_mlt(apply_rotation_vecs(mat_geo_to_sm, vecs))


def geodetic_height(x, y, z, lat, a=WGS84_A, b=WGS84_B):
    """Height above the ellipsoid given a point and its geodetic latitude.

    Uses h = p cos(lat) + z sin(lat) - a sqrt(1 - e2 sin^2 lat), which is
    stable at all latitudes.
    """
    e2 = (a * a - b * b) / (a * a)
    p = jnp.sqrt(x * x + y * y)
    sin_lat = jnp.sin(lat)
    return p * jnp.cos(lat) + z * sin_lat - a * jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)


def sm_to_latlon(smlat_deg, smlon_deg, mat_sm_to_geo, altitude=0.0, a=WGS84_A, b=WGS84_B):
    """Solar-magnetic spherical degrees -> geodetic degrees.

    Inverse of :func:`geo_to_mlat_mlt` composed with
    :func:`geodetic_to_ecef` at ``altitude``: the SM angles define a ray from
    the Earth's centre; the returned geodetic coordinates are the point on
    that ray at geodetic height ``altitude`` (found with two Newton steps,
    accurate to <1e-9 km).

    Deviation from the reference: auromat/coordinates/transform.py:461-485
    evaluates Bowring on the *unit-radius* point, which is not the inverse of
    its own forward conversion (geodetic lat of a point 1 km from the Earth's
    centre saturates near +-89 deg) and breaks the reference's own
    resampleMLatMLT -> mLatMlt plate-carree round trip. Intersecting the ray
    at the mapping altitude restores the intended semantics.
    """
    x, y, z = spherical_to_cartesian(
        None, jnp.deg2rad(smlat_deg), jnp.deg2rad(smlon_deg)
    )
    sm = jnp.stack([x, y, z], axis=-1)
    g = apply_rotation_vecs(mat_sm_to_geo, sm)  # unit direction in GEO
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    ai, bi = a + altitude, b + altitude
    t = 1.0 / jnp.sqrt((gx / ai) ** 2 + (gy / ai) ** 2 + (gz / bi) ** 2)
    lat = lon = None
    for _ in range(2):
        px, py, pz = t * gx, t * gy, t * gz
        lat, lon = ecef_to_geodetic(px, py, pz, a, b)
        h0 = geodetic_height(px, py, pz, lat, a, b)
        t = t + (altitude - h0)
    return jnp.rad2deg(lat), jnp.rad2deg(lon)


def wrap_longitude(lon_deg):
    """Wrap degrees into [-180, 180) (Angle.wrap_at(180 deg) equivalent)."""
    return (jnp.asarray(lon_deg) + 180.0) % 360.0 - 180.0


def unit_vectors(vecs, axis=-1):
    """Normalize vectors along an axis."""
    return vecs / jnp.linalg.norm(vecs, axis=axis, keepdims=True)


def angle_between(v1, v2, axis=-1):
    """Angle in radians between unit-vector arrays, clipped into [0, pi].

    Reference: auromat/utils.py:38-46.
    """
    dot = jnp.clip(jnp.sum(v1 * v2, axis=axis), -1.0, 1.0)
    return jnp.arccos(dot)
