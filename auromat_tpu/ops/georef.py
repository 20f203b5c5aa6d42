"""Fused per-pixel georeferencing: camera -> sky -> Earth in one jitted chain.

This replaces the reference's lazy-property pyramid
(auromat/mapping/astrometry.py:49-212, which materialises ~8 full-image
temporaries) with one fused device computation:

    pixel grid -> CD matmul -> TAN unproject -> celestial rotation (J2000 dirs)
    -> ray/ellipsoid intersection at emission altitude -> GEO rotation ->
    Bowring geodetic -> lat/lon/elevation (+ optional MLat/MLT from J2000)

All per-frame scalars (WCS solution, camera position, frame matrices) are
host-computed float64 and closed over / passed as small arrays; per-pixel math
is dtype-configurable (float64 for CPU parity, float32 on device — see
auromat_tpu.ops for precision strategy).

Frame-convention note (parity-relevant): like the reference, the ellipsoid is
treated as axis-aligned in the GCRS/J2000 frame (ignoring the ~0.07 deg
precession tilt of the true-of-date pole, reference mapping.py:1474-1510), and
ICRS directions are used as GCRS (astrometry.py:245-269).
"""

from dataclasses import dataclass
from datetime import datetime
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from auromat_tpu.constants import WGS84_A, WGS84_B
from auromat_tpu.coordinates.frames import FrameMatrices
from auromat_tpu.coordinates.wcs import TanWcs


@dataclass(frozen=True)
class GeorefParams:
    """Static (hashable) per-frame scalar calibration for the georef kernel.

    Arrays are stored as nested tuples so instances can be jit static args;
    use :meth:`from_wcs` to build from a parsed WCS header + camera state.
    """

    width: int
    height: int
    cd: tuple  # 2x2
    px_ref: float
    py_ref: float
    rotmat: tuple  # 3x3 native->celestial (ICRS~GCRS)
    camera_pos: tuple  # (3,) GCRS km
    altitude: float  # emission altitude km
    mat_j2000_to_geo: tuple  # 3x3
    mat_j2000_to_sm: tuple  # 3x3

    @staticmethod
    def from_wcs(wcs: TanWcs, camera_pos, photo_time: datetime, altitude=110.0,
                 frame_matrices: FrameMatrices = None):
        fm = frame_matrices or FrameMatrices(photo_time)
        # nested PYTHON floats, not np.float64 scalars: numpy scalars are
        # strongly typed in jax and PROMOTE every f32 array they touch to
        # f64, a far slower rate than f32 on an accelerator. Python
        # floats are weak: the chain computes in the
        # dtype of the pixel arrays, and the f64 CPU parity path is
        # bit-identical (float() preserves the value).
        t = lambda a: tuple(tuple(float(v) for v in row)
                            for row in np.asarray(a, dtype=np.float64))
        return GeorefParams(
            width=int(wcs.width),
            height=int(wcs.height),
            cd=t(wcs.cd),
            px_ref=float(wcs.px_ref),
            py_ref=float(wcs.py_ref),
            rotmat=t(wcs.rotmat),
            camera_pos=tuple(float(v) for v in np.asarray(camera_pos)),
            altitude=float(altitude),
            mat_j2000_to_geo=t(fm.j2000_to_geo),
            mat_j2000_to_sm=t(fm.j2000_to_sm),
        )


def _pixel_dirs(p, px, py):
    """TAN unprojection to unit J2000 direction components (fused).

    Trig-free: with u = (180/pi)/R the native-spherical direction is
        (cos t cos phi, cos t sin phi, sin t)
      = (-y, x, u) / sqrt(x^2 + y^2 + u^2)
    since cos(arctan2(x,-y)) = -y/R, sin = x/R, and sin(arctan u') with
    u' = u/R collapses against R. Equivalent to the reference formulation
    (auromat/coordinates/wcs.py:106-141) to ~1 ulp but with zero
    transcendentals — only one rsqrt per pixel on the VPU.
    """
    cd = p.cd
    dx = px - (p.px_ref - 1.0)
    dy = py - (p.py_ref - 1.0)
    x = cd[0][0] * dx + cd[0][1] * dy
    y = cd[1][0] * dx + cd[1][1] * dy
    u = 180.0 / jnp.pi
    inv = jax.lax.rsqrt(x * x + y * y + u * u)
    l_ = -y * inv
    m_ = x * inv
    n_ = u * inv
    rm = p.rotmat
    vx = rm[0][0] * l_ + rm[0][1] * m_ + rm[0][2] * n_
    vy = rm[1][0] * l_ + rm[1][1] * m_ + rm[1][2] * n_
    vz = rm[2][0] * l_ + rm[2][1] * m_ + rm[2][2] * n_
    return vx, vy, vz


def _intersect(p, vx, vy, vz, dtype):
    """Directed ray/inflated-ellipsoid intersection (origin = camera)."""
    a = WGS84_A + p.altitude
    b = WGS84_B + p.altitude
    ox, oy, oz = p.camera_pos[0], p.camera_pos[1], p.camera_pos[2]
    # works for both static python floats and traced per-frame scalars;
    # for static params XLA constant-folds the select
    inside = (ox / a) ** 2 + (oy / a) ** 2 + (oz / b) ** 2 < 1.0
    # scaled-space quadratic (identical formulation to the reference,
    # intersection.py:58-104, for bit-level parity)
    inv_a, inv_b = 1.0 / a, 1.0 / b
    dsx, dsy, dsz = vx * inv_a, vy * inv_a, vz * inv_b
    osx = jnp.asarray(-ox * inv_a, dtype=dtype)
    osy = jnp.asarray(-oy * inv_a, dtype=dtype)
    osz = jnp.asarray(-oz * inv_b, dtype=dtype)
    b_q = dsx * osx + dsy * osy + dsz * osz
    a_q = dsx * dsx + dsy * dsy + dsz * dsz
    c_q = osx * osx + osy * osy + osz * osz
    root = jnp.sqrt(b_q * b_q - c_q * a_q + a_q)
    d = jnp.where(inside, b_q + root, b_q - root)
    d = jnp.where(d < 0, jnp.nan, d) / a_q
    return ox + d * vx, oy + d * vy, oz + d * vz


def _bowring(x, y, z, a=WGS84_A, b=WGS84_B):
    e2 = (a * a - b * b) / (a * a)
    d = (a * a - b * b) / b
    p2 = x * x + y * y
    p = jnp.sqrt(p2)
    r = jnp.sqrt(p2 + z * z)
    tu = b * z * (1.0 + d / r) / (a * p)
    tu2 = tu * tu
    cu = 1.0 / jnp.sqrt(1.0 + tu2)
    cu3 = cu * cu * cu
    su3 = cu3 * tu2 * tu
    lat = jnp.arctan((z + d * su3) / (p - e2 * a * cu3))
    lon = jnp.arctan2(y, x)
    return lat, lon


def _rot(m, x, y, z):
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )


def _grid(width, height, corner, dtype):
    off = -0.5 if corner else 0.0
    extra = 1 if corner else 0
    xs = jnp.arange(off, off + width + extra, dtype=dtype)
    ys = jnp.arange(off, off + height + extra, dtype=dtype)
    return jnp.meshgrid(xs, ys)


def _latlon_from_j2000(p, ix, iy, iz):
    gx, gy, gz = _rot(p.mat_j2000_to_geo, ix, iy, iz)
    lat, lon = _bowring(gx, gy, gz)
    return jnp.rad2deg(lat), jnp.rad2deg(lon)


def _mlatmlt_from_j2000(p, ix, iy, iz):
    sx, sy, sz = _rot(p.mat_j2000_to_sm, ix, iy, iz)
    mlat = jnp.rad2deg(jnp.arctan2(sz, jnp.sqrt(sx * sx + sy * sy)))
    mlt = jnp.rad2deg(jnp.arctan2(sy, sx)) * (24.0 / 360.0) + 12.0
    return mlat, mlt


def _elevation_deg(vx, vy, vz, ix, iy, iz):
    """90 deg minus angle(-ray, unit(intersection)).

    Reference: auromat/mapping/astrometry.py:200-212 — note the ray direction
    is used as-is (it is unit in the exact path, slightly short in the
    fast-centre path; replicated for parity).
    """
    ilen = jnp.sqrt(ix * ix + iy * iy + iz * iz)
    dot = -(vx * ix + vy * iy + vz * iz) / ilen
    alpha = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    return 90.0 - jnp.rad2deg(alpha)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def georeference(params: GeorefParams, fast_center=False, with_mlatmlt=True,
                 dtype=jnp.float64):
    """Fully georeference one frame.

    :param fast_center: compute pixel-centre values as the mean of the 4
        surrounding corner values instead of a second full evaluation
        (reference astrometry.py:154-160). Halves the work; centres then have
        NaN wherever *any* corner is NaN, which pre-satisfies the mask
        invariants (reference astrometry.py:35-40).
    :returns: dict with keys lats, lons (h+1, w+1); lats_center, lons_center,
        elevation (h, w); and mlat, mlt, mlat_center, mlt_center if requested.
        All NaN-masked where rays miss the inflated ellipsoid.
    """
    return _georeference_body(params, params.width, params.height,
                              fast_center, with_mlatmlt, dtype)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def georeference_generic(wcs, params: GeorefParams, fast_center=False,
                         with_mlatmlt=True, dtype=jnp.float64):
    """:func:`georeference` for ANY supported FITS projection.

    Pixel directions come from the generic plane->native->celestial
    chain of the :mod:`auromat_tpu.coordinates.wcs` family classes
    (``pix2world_dirs``) instead of the fused trig-free TAN
    unprojection; the downstream chain — ray/ellipsoid intersection,
    Bowring, elevation, MLat/MLT — is shared. This is the reference's
    astropy-fallback georeferencing role (reference wcs.py:18-64 via
    astrometry.py:49-64) for non-TAN headers; off-map pixels (e.g.
    outside the SIN disc) produce NaN directions and flow into the NaN
    masks naturally.

    The whole chain is jitted with the wcs object static (its host
    float64 header constants fold at trace time — one compilation per
    wcs instance; essential for iterative inverses like PCO's bisection,
    which would otherwise issue hundreds of eager full-frame ops). The
    whole per-pixel chain computes in the REQUESTED dtype: header
    constants ride as weak python floats (pix2world_dirs), so an f32
    call is true f32 end to end — np-f64 constants previously promoted
    it to f64, a far slower rate than f32 on an accelerator. The measured f32
    floor vs the f64 oracle is ~1.6e-3 deg
    (tests/test_georef.py::test_generic_projection_f32_floor).
    """
    from auromat_tpu.coordinates.wcs import pix2world_dirs

    def dirs(px, py):
        # planar components: the stacked (..., 3) form costs a copy per
        # component slice
        vx, vy, vz = pix2world_dirs(wcs, px, py, origin=0)
        return vx.astype(dtype), vy.astype(dtype), vz.astype(dtype)

    return _georeference_body(params, params.width, params.height,
                              fast_center, with_mlatmlt, dtype,
                              dirs_fn=dirs)


def georeference_dyn(p, width, height, fast_center=False, with_mlatmlt=True,
                     dtype=jnp.float32):
    """:func:`georeference` with TRACED per-frame params (DynGeorefParams).

    vmap/shard_map-safe: batch a frame burst by stacking params
    (``DynGeorefParams.stack``) and vmapping this function — the device
    replacement for the reference's NuMap process pipeline (SURVEY.md P2).
    """
    return _georeference_body(p, width, height, fast_center, with_mlatmlt,
                              dtype)


def _georeference_body(params, width, height, fast_center, with_mlatmlt,
                       dtype, dirs_fn=None):
    dirs = dirs_fn or (lambda gx, gy: _pixel_dirs(params, gx, gy))
    px, py = _grid(width, height, corner=True, dtype=dtype)
    vx, vy, vz = dirs(px, py)
    ix, iy, iz = _intersect(params, vx, vy, vz, dtype)
    lats, lons = _latlon_from_j2000(params, ix, iy, iz)
    out = {"lats": lats, "lons": lons}

    if fast_center:
        mean4 = lambda a: (a[:-1, :-1] + a[:-1, 1:] + a[1:, 1:] + a[1:, :-1]) * 0.25
        cvx, cvy, cvz = mean4(vx), mean4(vy), mean4(vz)
        cix, ciy, ciz = mean4(ix), mean4(iy), mean4(iz)
    else:
        cpx, cpy = _grid(width, height, corner=False, dtype=dtype)
        cvx, cvy, cvz = dirs(cpx, cpy)
        cix, ciy, ciz = _intersect(params, cvx, cvy, cvz, dtype)

    lats_c, lons_c = _latlon_from_j2000(params, cix, ciy, ciz)
    out["lats_center"] = lats_c
    out["lons_center"] = lons_c
    out["elevation"] = _elevation_deg(cvx, cvy, cvz, cix, ciy, ciz)

    if with_mlatmlt:
        out["mlat"], out["mlt"] = _mlatmlt_from_j2000(params, ix, iy, iz)
        out["mlat_center"], out["mlt_center"] = _mlatmlt_from_j2000(
            params, cix, ciy, ciz
        )
    return out


class DynGeorefParams(NamedTuple):
    """Per-frame calibration as a pytree of arrays — vmappable over frames.

    Same fields as :class:`GeorefParams` minus the static image shape. Use
    :meth:`stack` to batch a frame sequence: the per-frame scalars become the
    leading axis and the whole chain vmaps (SURVEY.md P2: the reference's
    NuMap process pipeline becomes a batched device call).
    """

    cd: jnp.ndarray  # (2, 2)
    px_ref: jnp.ndarray  # ()
    py_ref: jnp.ndarray  # ()
    rotmat: jnp.ndarray  # (3, 3)
    camera_pos: jnp.ndarray  # (3,)
    altitude: jnp.ndarray  # ()
    mat_j2000_to_geo: jnp.ndarray  # (3, 3)
    mat_j2000_to_sm: jnp.ndarray  # (3, 3)

    @staticmethod
    def from_static(p: GeorefParams, dtype=jnp.float64):
        a = lambda v: jnp.asarray(np.asarray(v), dtype=dtype)
        return DynGeorefParams(
            cd=a(p.cd), px_ref=a(p.px_ref), py_ref=a(p.py_ref), rotmat=a(p.rotmat),
            camera_pos=a(p.camera_pos), altitude=a(p.altitude),
            mat_j2000_to_geo=a(p.mat_j2000_to_geo), mat_j2000_to_sm=a(p.mat_j2000_to_sm),
        )

    @staticmethod
    def stack(params_list, dtype=jnp.float64):
        """Stack per-frame calibration into HOST numpy arrays.

        The stacked params are jit-call INPUTS: one batched transfer at
        dispatch, instead of ~8 eager device ops per frame for a jnp-based
        stacking.
        """
        npdt = np.dtype(jnp.dtype(dtype).name)
        return DynGeorefParams(**{
            f: np.stack([np.asarray(getattr(p, f), dtype=npdt)
                         for p in params_list])
            for f in DynGeorefParams._fields})


def georef_dirs_dyn(p: DynGeorefParams, px, py):
    """Pixel coords -> J2000 unit directions with traced per-frame params."""
    return _pixel_dirs(p, px, py)


def georef_latlon_dyn(p: DynGeorefParams, px, py, dtype=jnp.float32,
                      with_elevation=False, with_mlatmlt=False):
    """Georeference pixel coords with traced params (vmap/shard_map safe).

    :returns: dict with lat, lon (+ elevation, mlat, mlt when requested)
    """
    vx, vy, vz = _pixel_dirs(p, px, py)
    ix, iy, iz = _intersect(p, vx, vy, vz, dtype)
    lat, lon = _latlon_from_j2000(p, ix, iy, iz)
    out = {"lat": lat, "lon": lon}
    if with_elevation:
        out["elevation"] = _elevation_deg(vx, vy, vz, ix, iy, iz)
    if with_mlatmlt:
        out["mlat"], out["mlt"] = _mlatmlt_from_j2000(p, ix, iy, iz)
    return out


@partial(jax.jit, static_argnums=(0, 3))
def georeference_points(params: GeorefParams, px, py, dtype=jnp.float64):
    """Georeference arbitrary pixel coordinates (same chain, explicit grid)."""
    px = jnp.asarray(px, dtype=dtype)
    py = jnp.asarray(py, dtype=dtype)
    vx, vy, vz = _pixel_dirs(params, px, py)
    ix, iy, iz = _intersect(params, vx, vy, vz, dtype)
    lat, lon = _latlon_from_j2000(params, ix, iy, iz)
    return lat, lon


@partial(jax.jit, static_argnums=(0, 1, 4, 5))
def georeference_points_generic(wcs, params: GeorefParams, px, py,
                                dtype=jnp.float64, with_elevation=False):
    """:func:`georeference_points` for ANY supported FITS projection.

    Directions come from the generic plane->native->celestial chain
    (:func:`auromat_tpu.coordinates.wcs.pix2world_dirs`, the
    reference's astropy-fallback role — reference wcs.py:18-64) instead
    of the fused TAN unprojection; intersection and Bowring are shared.
    This is the measurement surface for on-chip generic-projection
    parity (chip_smoke.py's generic phase, bench.py generic keys).
    """
    from auromat_tpu.coordinates.wcs import pix2world_dirs

    px = jnp.asarray(px, dtype=dtype)
    py = jnp.asarray(py, dtype=dtype)
    vx, vy, vz = (v.astype(dtype)
                  for v in pix2world_dirs(wcs, px, py, origin=0))
    ix, iy, iz = _intersect(params, vx, vy, vz, dtype)
    lat, lon = _latlon_from_j2000(params, ix, iy, iz)
    if with_elevation:
        return lat, lon, _elevation_deg(vx, vy, vz, ix, iy, iz)
    return lat, lon


# ---------------------------------------------------------------------------
# double-float (df64) chain: <1e-6 deg parity in f32 pairs
# ---------------------------------------------------------------------------


def _df_zenithal_dirs(projection, x, y, c):
    """df64 plane->native-direction for the non-TAN zenithal family.

    Intermediate world coords (x, y) in degrees (df pairs) -> UNIT
    direction components (l, m, n) in the native frame, all in df64.
    Out-of-domain points (e.g. beyond the SIN disc) produce NaN, which
    flows into the miss mask through the intersection discriminant —
    identical semantics to the f32 generic chain
    (coordinates.wcs._theta_from_r). Each radial law reduces to its
    trig-free algebraic form (the same elimination the fused TAN path
    uses; reference reaches these projections via its astropy fallback,
    reference wcs.py:18-64):

      SIN: n = sqrt(1 - q^2 r^2),         (l, m) = q (-y, x)
      ZEA: n = 1 - 2 rho^2,               (l, m) = q sqrt(1-rho^2) (-y, x)
      STG: n = (1 - t^2)/(1 + t^2),       (l, m) = q/(1+t^2) (-y, x)
      ARC: n = cos(q r),                  (l, m) = sin(q r)/r (-y, x)

    with q = pi/180, rho = (pi/360) r, t = (pi/360) r. Unitness is exact
    algebraically (l^2+m^2+n^2 = 1 for each law), so the downstream
    elevation (which uses the ray as-is) keeps its contract. df constants
    ride as the SECOND operand of add (XLA-CPU literal-first two_sum
    folding hazard — see CLAUDE.md round-2 notes).
    """
    from auromat_tpu.ops import dfloat as dfl

    q = np.pi / 180.0
    r2 = dfl.add(dfl.mul(x, x), dfl.mul(y, y))
    if projection == "SIN":
        n_ = dfl.sqrt(dfl.add(dfl.neg(dfl.mul(c(q * q), r2)), c(1.0)))
        l_ = dfl.neg(dfl.mul(c(q), y))
        m_ = dfl.mul(c(q), x)
    elif projection == "ZEA":
        rho2 = dfl.mul(c((np.pi / 360.0) ** 2), r2)
        n_ = dfl.add(dfl.neg(dfl.scale(rho2, 2.0)), c(1.0))
        k = dfl.mul(c(q), dfl.sqrt(dfl.add(dfl.neg(rho2), c(1.0))))
        l_ = dfl.neg(dfl.mul(k, y))
        m_ = dfl.mul(k, x)
    elif projection == "STG":
        t2 = dfl.mul(c((np.pi / 360.0) ** 2), r2)
        inv = dfl.div(c(1.0), dfl.add(t2, c(1.0)))
        n_ = dfl.mul(dfl.add(dfl.neg(t2), c(1.0)), inv)
        g = dfl.mul(c(q), inv)
        l_ = dfl.neg(dfl.mul(g, y))
        m_ = dfl.mul(g, x)
    elif projection == "ARC":
        r = dfl.sqrt(r2)
        # clamp away the exact-centre 0/0 (sin(qr)/r -> q as r -> 0; a
        # 1e-30 floor keeps the ratio exact to f32 while avoiding NaN)
        r = dfl.DF(jnp.maximum(r.hi, jnp.float32(1e-30)), r.lo)
        zeta = dfl.mul(c(q), r)
        s, n_ = dfl.sincos(zeta)
        g = dfl.div(s, r)
        l_ = dfl.neg(dfl.mul(g, y))
        m_ = dfl.mul(g, x)
        # beyond the antipode (zeta > pi) the law is out of domain
        nan = jnp.float32(jnp.nan)
        n_ = dfl.DF(jnp.where(zeta.hi > jnp.float32(np.pi), nan, n_.hi),
                    n_.lo)
    else:
        raise NotImplementedError(
            f"df64 directions are implemented for the zenithal family "
            f"TAN/SIN/ZEA/ARC/STG; got {projection!r} (use dtype=float64 "
            "on CPU or float32)")
    return l_, m_, n_


def _cut(*vals):
    """Pass df values between two stages of the df chain through an
    optimization barrier (an identity on values). Without the cuts XLA
    fuses the whole chain — thousands of elementwise ops with five
    atan/atan2 — into one kernel, and its GPU compile did not finish in
    15 minutes (H100, JAX 0.9.0); each stage now compiles as kernels of
    its own, at the cost of writing a few per-pixel f32 limbs between
    them."""
    return jax.lax.optimization_barrier(vals)


def _georef_df_body(params: GeorefParams, px, py, with_elevation=False,
                    with_mlatmlt=False, projection="TAN"):
    """df64 georeference chain; returns dict of NaN-masked (hi, lo) pairs.

    Keys: lat, lon (+ elevation, mlat, mlt when requested) — every exported
    per-pixel variable of the CDF/netCDF schema (reference
    export/cdf.py:86-110, astrometry.py:170-212) at <1e-6 deg parity in
    f32 arithmetic. ``projection`` selects the plane->direction stage: the
    fused TAN form (default) or any zenithal radial law
    (:func:`_df_zenithal_dirs`); everything downstream — intersection,
    Bowring, elevation, MLat/MLT — is shared.
    """
    from auromat_tpu.ops import dfloat as dfl

    px = jnp.asarray(px, dtype=jnp.float32)
    py = jnp.asarray(py, dtype=jnp.float32)
    c = lambda v: dfl.from_f64_like(float(v), px)

    # TAN unprojection. A single-f32 cast of a fractional CRPIX
    # (astrometry.net emits e.g. 2128.3749) loses ~1e-4 px ~= 1e-6 deg —
    # 4 orders above the chain's 1e-10 deg accuracy. But a per-pixel df
    # subtraction of the full CRPIX makes dx.lo a nonzero ARRAY, defeating
    # XLA's literal-zero folding of the lo-limb products downstream
    # (measured: df64 17.5 -> 42.7 ms). Instead: subtract only the INTEGRAL
    # part per pixel (pixel coords are multiples of 0.5 < 2^13, so the f32
    # subtraction is exact and dx.lo stays a literal zero), and fold the
    # fractional CRPIX residual into the scalar df constants of the
    # CD-matrix stage, computed in f64 at trace time:
    #   x = cd00*(dx - fx) + cd01*(dy - fy)
    #     = (cd00*dx + cd01*dy) + (-cd00*fx - cd01*fy)
    rx, ry = params.px_ref - 1.0, params.py_ref - 1.0
    rx_int, ry_int = round(rx), round(ry)
    fx, fy = rx - rx_int, ry - ry_int
    dx = dfl.df(px - jnp.float32(rx_int))
    dy = dfl.df(py - jnp.float32(ry_int))
    cd = params.cd
    x = dfl.add(dfl.mul(c(cd[0][0]), dx), dfl.mul(c(cd[0][1]), dy))
    y = dfl.add(dfl.mul(c(cd[1][0]), dx), dfl.mul(c(cd[1][1]), dy))
    if fx != 0.0 or fy != 0.0:
        x = dfl.add(x, c(-(cd[0][0] * fx + cd[0][1] * fy)))
        y = dfl.add(y, c(-(cd[1][0] * fx + cd[1][1] * fy)))
    if projection == "TAN":
        u = c(180.0 / np.pi)
        s2 = dfl.add(dfl.add(dfl.mul(x, x), dfl.mul(y, y)), dfl.mul(u, u))
        inv = dfl.div(c(1.0), dfl.sqrt(s2))
        l_ = dfl.mul(dfl.neg(y), inv)
        m_ = dfl.mul(x, inv)
        n_ = dfl.mul(u, inv)
    else:
        l_, m_, n_ = _df_zenithal_dirs(projection, x, y, c)

    rm = params.rotmat

    def rot_row(row):
        return dfl.add(
            dfl.add(dfl.mul(c(row[0]), l_), dfl.mul(c(row[1]), m_)),
            dfl.mul(c(row[2]), n_),
        )

    vx, vy, vz = _cut(rot_row(rm[0]), rot_row(rm[1]), rot_row(rm[2]))

    # ray/inflated-ellipsoid intersection (same scaled-space quadratic)
    a_ax = WGS84_A + params.altitude
    b_ax = WGS84_B + params.altitude
    ox, oy, oz = params.camera_pos
    inv_a = 1.0 / a_ax
    inv_b = 1.0 / b_ax
    dsx = dfl.mul(vx, c(inv_a))
    dsy = dfl.mul(vy, c(inv_a))
    dsz = dfl.mul(vz, c(inv_b))
    osx = c(-ox * inv_a)
    osy = c(-oy * inv_a)
    osz = c(-oz * inv_b)
    b_q = dfl.dot3(dsx, dsy, dsz, osx, osy, osz)
    a_q = dfl.dot3(dsx, dsy, dsz, dsx, dsy, dsz)
    c_q = dfl.dot3(osx, osy, osz, osx, osy, osz)
    disc = dfl.add(
        dfl.sub(dfl.mul(b_q, b_q), dfl.mul(c_q, a_q)), a_q
    )
    root = dfl.sqrt(disc)
    inside = (ox / a_ax) ** 2 + (oy / a_ax) ** 2 + (oz / b_ax) ** 2 < 1.0
    d = dfl.add(b_q, root) if inside else dfl.sub(b_q, root)
    # a negative discriminant (no intersection) makes root NaN, which a
    # NaN test on disc itself would not catch: test its sign instead
    miss = ~(disc.hi >= 0.0) | (d.hi < 0)
    d = dfl.div(d, a_q)
    ix_ = dfl.add(dfl.mul(d, vx), c(ox))
    iy_ = dfl.add(dfl.mul(d, vy), c(oy))
    iz_ = dfl.add(dfl.mul(d, vz), c(oz))
    ix_, iy_, iz_, miss = _cut(ix_, iy_, iz_, miss)

    # J2000 -> GEO rotation
    mg = params.mat_j2000_to_geo

    def rot3(row):
        return dfl.add(
            dfl.add(dfl.mul(c(row[0]), ix_), dfl.mul(c(row[1]), iy_)),
            dfl.mul(c(row[2]), iz_),
        )

    gx, gy, gz = rot3(mg[0]), rot3(mg[1]), rot3(mg[2])

    # Bowring geodetic conversion in df
    a_e = WGS84_A
    b_e = WGS84_B
    e2 = (a_e * a_e - b_e * b_e) / (a_e * a_e)
    dd = (a_e * a_e - b_e * b_e) / b_e
    p2 = dfl.add(dfl.mul(gx, gx), dfl.mul(gy, gy))
    p = dfl.sqrt(p2)
    r = dfl.sqrt(dfl.add(p2, dfl.mul(gz, gz)))
    tu = dfl.div(
        dfl.mul(dfl.mul(c(b_e), gz),
                dfl.add(dfl.div(c(dd), r), c(1.0))),
        dfl.mul(c(a_e), p),
    )
    tu2 = dfl.mul(tu, tu)
    cu = dfl.div(c(1.0), dfl.sqrt(dfl.add(tu2, c(1.0))))
    cu3 = dfl.mul(dfl.mul(cu, cu), cu)
    su3 = dfl.mul(dfl.mul(cu3, tu2), tu)
    tp = dfl.div(
        dfl.add(gz, dfl.mul(c(dd), su3)),
        dfl.sub(p, dfl.mul(c(e2 * a_e), cu3)),
    )
    lat, gx, gy, gz, p2 = _cut(dfl.mul(dfl.atan(tp), c(180.0 / np.pi)),
                               gx, gy, gz, p2)
    lon = dfl.mul(dfl.atan2(gy, gx), c(180.0 / np.pi))
    out = {"lat": lat, "lon": lon}

    # r^2 = |intersection|^2 (rotation-invariant) — shared by the asin
    # forms below; r itself was consumed by Bowring above
    out, r2 = _cut(out, dfl.add(p2, dfl.mul(gz, gz)))

    if with_elevation:
        # elevation = 90 - acos = asin(-ray.i / |i|)
        #           = atan2(-ray.i, sqrt(|i|^2 - (ray.i)^2))
        # (reference astrometry.py:200-212). The r^2 form skips the
        # normalizing division AND the (1-t)(1+t) clamp entirely.
        mdot = dfl.neg(dfl.dot3(vx, vy, vz, ix_, iy_, iz_))
        s2 = dfl.sub(r2, dfl.mul(mdot, mdot))
        # clamp the epsilon-negative rounding spill at |elevation| -> 90
        s2 = dfl.DF(jnp.maximum(s2.hi, 0.0),
                    jnp.where(s2.hi > 0.0, s2.lo, 0.0))
        out["elevation"] = dfl.mul(dfl.atan2(mdot, dfl.sqrt(s2)),
                                   c(180.0 / np.pi))
        out, r2 = _cut(out, r2)

    if with_mlatmlt:
        # J2000 -> SM rotation on the intersections, then magnetic
        # latitude / local time (reference astrometry.py:170-198 computes
        # MLat/MLT straight from the J2000 intersections, same here)
        ms = params.mat_j2000_to_sm

        def rot3m(row):
            return dfl.add(
                dfl.add(dfl.mul(c(row[0]), ix_), dfl.mul(c(row[1]), iy_)),
                dfl.mul(c(row[2]), iz_),
            )

        sx, sy, sz = rot3m(ms[0]), rot3m(ms[1]), rot3m(ms[2])
        # mlat = asin(sz/r) = atan2(sz, sqrt(r^2 - sz^2)): reuses r^2
        # instead of a second sx^2+sy^2 reduction
        h2 = dfl.sub(r2, dfl.mul(sz, sz))
        h2 = dfl.DF(jnp.maximum(h2.hi, 0.0),
                    jnp.where(h2.hi > 0.0, h2.lo, 0.0))
        out["mlat"] = dfl.mul(dfl.atan2(sz, dfl.sqrt(h2)), c(180.0 / np.pi))
        out, sx, sy = _cut(out, sx, sy)
        # mlt = rad2deg(atan2)*(24/360) + 12 = atan2 * (12/pi) + 12
        out["mlt"] = dfl.add(dfl.mul(dfl.atan2(sy, sx), c(12.0 / np.pi)),
                             c(12.0))

    nan = jnp.float32(jnp.nan)
    return {
        k: (jnp.where(miss, nan, v.hi), jnp.where(miss, nan, v.lo))
        for k, v in out.items()
    }


def georeference_points_df(params: GeorefParams, px, py):
    """Georeference pixel coordinates in double-float precision.

    The f32 chain bottoms out around ~1e-2..1e-3 deg (f32 cannot place a
    point on Earth better than ~0.4 m, and one f32 arctan already rounds at
    ~6e-6 deg). This variant runs the whole pixel->lat/lon chain in (hi, lo)
    f32 pairs (auromat_tpu.ops.dfloat), reaching float64-grade accuracy
    from f32 arithmetic (SURVEY.md section 7 "hard parts").

    ~10x the flops of the f32 chain; use for parity-critical production
    output, keep the f32 chain for preview/throughput work.

    :returns: (lat_hi, lat_lo, lon_hi, lon_lo) degree pairs — keep the pair;
        collapsing to a single f32 would throw away the precision (f32 ulp at
        60 deg is ~4e-6 deg). See :func:`georeference_points_df64`.
    """
    out = _georef_df_body(params, px, py)
    return out["lat"][0], out["lat"][1], out["lon"][0], out["lon"][1]


_georef_df_body_jit = jax.jit(
    _georef_df_body, static_argnums=0,
    static_argnames=("with_elevation", "with_mlatmlt", "projection"),
)


def georeference_points_df_full(params: GeorefParams, px, py,
                                with_elevation=True, with_mlatmlt=True,
                                projection="TAN"):
    """df64 chain over EVERY exported per-pixel variable (lat, lon,
    elevation, mlat, mlt) as NaN-masked (hi, lo) f32 pairs — the
    device-resident full-precision production export.

    The chain is VPU-FLOP-bound (each df atan2 is a dominant cost), so the
    variable set is selectable: ``with_elevation=False`` /
    ``with_mlatmlt=False`` skip those branches entirely (static jit args —
    one cached trace per combination, no retrace per call).
    ``projection`` extends the chain beyond TAN to the zenithal family
    (SIN/ZEA/ARC/STG; see :func:`_df_zenithal_dirs`).
    """
    return _georef_df_body_jit(params, px, py,
                               with_elevation=with_elevation,
                               with_mlatmlt=with_mlatmlt,
                               projection=projection)

_georeference_points_df_jit = jax.jit(georeference_points_df, static_argnums=0)


def georeference_points_df64(params: GeorefParams, px, py):
    """df64 chain collapsed to host float64 (lat_deg, lon_deg) arrays.

    Uses a module-level jit so repeated calls hit the trace cache (a fresh
    jax.jit wrapper per call would re-trace the whole df chain every time).
    """
    lat_hi, lat_lo, lon_hi, lon_lo = _georeference_points_df_jit(params, px, py)
    lat = np.asarray(lat_hi, dtype=np.float64) + np.asarray(lat_lo, dtype=np.float64)
    lon = np.asarray(lon_hi, dtype=np.float64) + np.asarray(lon_lo, dtype=np.float64)
    return lat, lon


def georeference_points_df64_full(params: GeorefParams, px, py,
                                  with_elevation=True, with_mlatmlt=True,
                                  projection="TAN"):
    """Full df64 chain collapsed to host float64 arrays (dict of deg)."""
    out = georeference_points_df_full(params, px, py,
                                      with_elevation=with_elevation,
                                      with_mlatmlt=with_mlatmlt,
                                      projection=projection)
    return {
        k: np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
        for k, (hi, lo) in out.items()
    }
