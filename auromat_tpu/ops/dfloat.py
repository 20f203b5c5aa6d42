"""Double-float ("df64") arithmetic: ~f64 precision from f32 pairs.

The georeferencing parity budget (<1e-6 deg, SURVEY.md section 7 "hard
parts") needs ~0.1 m positions on a 6.4e6 m sphere — beyond f32's ~0.4 m
representational floor, and even a single f32 arctan rounds at ~6e-6 deg.
This module implements error-free-transformation arithmetic on (hi, lo)
f32 pairs (Dekker 1971 / Knuth two-sum; no FMA assumed) plus the
transcendentals the geodetic chain needs (sqrt, sincos, and atan/atan2 via
a 17-entry table reduction + one df division + short f32 series), for
devices whose f64 rate is far below their f32 rate. Whether native f64
replaces it on a GPU is an open measurement (ROADMAP A6).

Accuracy: basic ops ~1e-14 relative; atan/atan2 ~2e-12 rad absolute —
comfortably inside the 1e-6 deg (1.7e-8 rad) budget.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np




_SPLIT = 4097.0  # 2^12 + 1 for binary32 Dekker splitting


class DF(NamedTuple):
    """A double-float value: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def df(hi, lo=None):
    hi = jnp.asarray(hi, dtype=jnp.float32)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return DF(hi, jnp.asarray(lo, dtype=jnp.float32))


def from_f64(value):
    """Host float64 scalar/array -> DF pair (exact to ~2^-48)."""
    value = np.asarray(value, dtype=np.float64)
    hi = value.astype(np.float32)
    lo = (value - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(x: DF):
    """DF -> host float64 (for testing)."""
    return np.asarray(x.hi, dtype=np.float64) + np.asarray(x.lo, dtype=np.float64)


def _two_sum(a, b):
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _quick_two_sum(a, b):
    # requires |a| >= |b|
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Split a into (hi, lo) with <=12 significand bits each, via mantissa
    masking. The classic Dekker split (t = 4097*a; hi = t - (t - a)) is NOT
    safe under jit: XLA CPU strips optimization barriers and LLVM contracts
    `t - a` into fma(a, 4097, -a), which uses the UNROUNDED product and
    collapses the split (hi ~= a, lo ~= 0), silently degrading df64 to f32.
    Bit masking has no multiply to contract.
    12x12-bit products fit exactly in f32's 24-bit significand."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        bits & np.uint32(0xFFFFF000), jnp.float32
    )
    return hi, a - hi


def _two_prod(a, b):
    """Exact product a*b = s + e via EXACT limb products only.

    The textbook two_prod (p = a*b; e = a_hi*b_hi - p + ...) is NOT safe
    under jit on CPU: XLA duplicates the cheap `a*b` multiply into every
    consumer fusion and LLVM contracts `s - a*b` into fma(-a, b, s), which
    uses the UNROUNDED product — the residual then mixes rounded and
    unrounded versions of the same product and the EFT identity breaks
    (observed: df64 silently degraded to f32-level error, ~5e-8 relative,
    whenever one operand was a broadcast constant). Optimization barriers
    are stripped by the XLA CPU pipeline and bitcast round-trips are folded,
    so the only robust defense is to make every product EXACT: with <=12-bit
    limbs from :func:`_split`, each partial product fits f32's 24-bit
    significand exactly, so fma(x, y, c) == round(x*y) + c bit-for-bit and
    contraction becomes harmless. The remaining ops are adds, which XLA/LLVM
    never reassociate at default fast-math settings.
    """
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    p11 = a_hi * b_hi  # all four partial products are exact (12x12 bits)
    p12 = a_hi * b_lo
    p21 = a_lo * b_hi
    p22 = a_lo * b_lo
    s, e1 = _two_sum(p12, p21)
    p, e2 = _two_sum(p11, s)
    p, e3 = _quick_two_sum(p, p22)
    return p, (e1 + e2) + e3


def add(x: DF, y: DF) -> DF:
    # accurate (IEEE) variant: the sloppy single-two-sum add loses ~8 digits
    # when adding near-cancelling opposite-sign values (series evaluation!)
    # CALLER HAZARD: do not pass a broadcast LITERAL constant as the FIRST
    # operand under jit on CPU — XLA's algebraic simplifier folds the
    # two_sum error term (measured: add(df(1), y) degrades to f32, while
    # add(y, df(1)) stays exact). Put the constant second.
    s1, s2 = _two_sum(x.hi, y.hi)
    t1, t2 = _two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(s1, s2)
    return DF(hi, lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def mul(x: DF, y: DF) -> DF:
    p, e = _two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def div(x: DF, y: DF) -> DF:
    # residuals written as add(neg(m), x) so a literal-constant numerator
    # (div(df(1), y) — reciprocals!) never reaches add() as the first
    # operand (the XLA CPU folding hazard documented on add()).
    q1 = x.hi / y.hi
    r = add(neg(mul(df(q1), y)), x)
    q2 = r.hi / y.hi
    r = add(neg(mul(df(q2), y)), r)
    q3 = r.hi / y.hi
    s, e = _quick_two_sum(q1, q2)
    return add(DF(s, e), df(q3))


def sqrt(x: DF) -> DF:
    """Newton-refined square root (Karp-Markstein style).

    Zero-safe: sqrt(DF(0,0)) = DF(0,0). Without the guard the Newton
    correction divides 0/0 -> NaN, and atan2(y, NaN) then silently
    returns 0 — this bit the df64 elevation/mlat chain at pixels whose
    epsilon-negative clamp fired (|elevation| -> 90 deg exported as 0).
    """
    s1 = jnp.sqrt(x.hi)
    # one df Newton step: s = s1 + (x - s1^2) / (2 s1)
    r = sub(x, mul(df(s1), df(s1)))
    denom = 2.0 * s1
    corr = jnp.where(s1 > 0.0, r.hi / denom, 0.0)
    lo_corr = jnp.where(s1 > 0.0, r.lo / denom, 0.0)
    hi, lo = _quick_two_sum(s1, corr + lo_corr)
    return DF(hi, lo)


def scale(x: DF, c) -> DF:
    """Multiply by an exactly-representable f32 constant."""
    return mul(x, df(jnp.float32(c)))


def dot3(ax, ay, az, bx, by, bz) -> DF:
    """Accurate 3-component dot product of DF vectors."""
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


PI = (3.1415927410125732, -8.742277657347586e-08)
PI_OVER_2 = (1.5707963705062866, -4.371138828673793e-08)


def _df_const(pair):
    return DF(jnp.float32(pair[0]), jnp.float32(pair[1]))


def _sincos_series(r: DF):
    """sin/cos of |r| <= pi/4 via Taylor series in df arithmetic."""
    r2 = mul(r, r)
    # sin: r (1 - r2/3! + r2^2/5! - ...) ; 8 terms reach ~1e-17 at pi/4
    sin_coeffs = [
        1.0, -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880,
        -1.0 / 39916800, 1.0 / 6227020800.0, -1.0 / 1307674368000.0,
    ]
    cos_coeffs = [
        1.0, -0.5, 1.0 / 24, -1.0 / 720, 1.0 / 40320,
        -1.0 / 3628800, 1.0 / 479001600.0, -1.0 / 87178291200.0,
    ]

    def horner(coeffs):
        acc = df(jnp.full_like(r.hi, np.float32(coeffs[-1])))
        for c in reversed(coeffs[:-1]):
            acc = add(mul(acc, r2), from_f64_like(c, r.hi))
        return acc

    sin_r = mul(r, horner(sin_coeffs))
    cos_r = horner(cos_coeffs)
    return sin_r, cos_r


def from_f64_like(value, like):
    v = np.float64(value)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return DF(jnp.full_like(like, hi), jnp.full_like(like, lo))


def sincos(x: DF):
    """sin and cos of a DF angle (|x| < ~10 rad)."""
    half_pi = _df_const(PI_OVER_2)
    k = jnp.round(x.hi / jnp.float32(np.pi / 2))
    r = sub(x, mul(DF(jnp.full_like(x.hi, half_pi.hi), jnp.full_like(x.hi, half_pi.lo)), df(k)))
    sin_r, cos_r = _sincos_series(r)
    k4 = jnp.mod(k, 4.0)
    # rotate by k * pi/2
    sin_x_hi = jnp.select(
        [k4 == 0, k4 == 1, k4 == 2], [sin_r.hi, cos_r.hi, -sin_r.hi], -cos_r.hi
    )
    sin_x_lo = jnp.select(
        [k4 == 0, k4 == 1, k4 == 2], [sin_r.lo, cos_r.lo, -sin_r.lo], -cos_r.lo
    )
    cos_x_hi = jnp.select(
        [k4 == 0, k4 == 1, k4 == 2], [cos_r.hi, -sin_r.hi, -cos_r.hi], sin_r.hi
    )
    cos_x_lo = jnp.select(
        [k4 == 0, k4 == 1, k4 == 2], [cos_r.lo, -sin_r.lo, -cos_r.lo], sin_r.lo
    )
    return DF(sin_x_hi, sin_x_lo), DF(cos_x_hi, cos_x_lo)


# atan(k/16) for k = 0..16 as (hi, lo) f32 pairs (f64-exact split)
_ATAN_TABLE = np.arctan(np.arange(17, dtype=np.float64) / 16.0)
_ATAN_HI = _ATAN_TABLE.astype(np.float32)
_ATAN_LO = (_ATAN_TABLE - _ATAN_HI.astype(np.float64)).astype(np.float32)


def _atan_core(num: DF, den: DF) -> DF:
    """atan(num/den) for 0 <= num <= den via table reduction with ONE df
    division — the shared first-octant core of atan/atan2.

    The table node k is estimated from the cheap f32 hi-limb ratio, then
    the residual is formed WITHOUT materializing t = num/den:
        r = (num - a0 den) / (den + a0 num),   a0 = k/16
    (substituting t = num/den into (t - a0)/(1 + t a0)); numerator and
    denominator are df-exact linear combinations, so the only df division
    of the whole reduction is r itself. The previous formulation paid 2-3
    df divisions per atan2 (pre-divide + reciprocal branch + residual) —
    measured 33.7 -> 24 ms class on the 5-atan df64 full chain.

    An f32-rounded k may sit one node off near 1/32 boundaries; |r| then
    grows to <= ~3/32 where the series' omitted r^9/9 term is < 5e-11 rad
    (3e-9 deg) — still 2.5 orders under the 1e-6 deg parity gate.

    den.hi == 0 (both args zero) yields 0.
    """
    safe = den.hi > 0.0
    k = jnp.clip(jnp.round(
        jnp.where(safe, num.hi / jnp.where(safe, den.hi, 1.0), 0.0) * 16.0),
        0.0, 16.0)
    a0 = k * jnp.float32(1.0 / 16.0)  # k/16 is exactly representable
    rn = sub(num, mul(den, df(a0)))
    # constant operand LAST in adds: XLA's CPU algebraic simplifier folds
    # the two_sum error term of add(<literal>, y) and silently degrades
    # the pair to f32 (atan() passes a broadcast-ones den) — see
    # test_dfloat test_add_constant_operand_under_jit
    rd = add(mul(num, df(a0)), den)
    # 2-term division: |r| <= ~3/32, so the q3 refinement of the full
    # div() buys nothing (relative 2^-46 already puts the residual's
    # error orders below the series truncation)
    q1 = rn.hi / rd.hi
    rr_ = add(neg(mul(df(q1), rd)), rn)
    q2 = rr_.hi / rd.hi
    r = DF(*_quick_two_sum(q1, q2))
    r = DF(jnp.where(safe, r.hi, 0.0), jnp.where(safe, r.lo, 0.0))
    # table lookup as a fused select-chain: 17 compare+selects per limb
    # collapse into ONE elementwise pass (no matmul, so no reduced-
    # precision dot can touch the table values)
    ta_hi = jnp.full_like(k, float(_ATAN_HI[0]))
    ta_lo = jnp.full_like(k, float(_ATAN_LO[0]))
    for i in range(1, 17):
        m = k == np.float32(i)
        ta_hi = jnp.where(m, np.float32(_ATAN_HI[i]), ta_hi)
        ta_lo = jnp.where(m, np.float32(_ATAN_LO[i]), ta_lo)
    rr = r.hi
    r2 = rr * rr
    corr = rr * r2 * (jnp.float32(-1.0 / 3.0)
                      + r2 * (jnp.float32(0.2) - r2 * jnp.float32(1.0 / 7.0)))
    return add(DF(ta_hi, ta_lo), add(r, df(corr)))


def atan2(y: DF, x: DF) -> DF:
    """Quadrant-aware arctan of y/x in df precision (single-division core).

    First-octant reduction: phi = atan(min/max of (|y|, |x|)) via
    :func:`_atan_core`, mirrored by pi/2 - phi when |y| > |x|, by pi - phi
    when x < 0, and negated for y < 0 — selects only, no extra division.
    """
    ay = DF(jnp.abs(y.hi), jnp.where(y.hi < 0, -y.lo, y.lo))
    ax = DF(jnp.abs(x.hi), jnp.where(x.hi < 0, -x.lo, x.lo))
    swap = ay.hi > ax.hi
    num = DF(jnp.where(swap, ax.hi, ay.hi), jnp.where(swap, ax.lo, ay.lo))
    den = DF(jnp.where(swap, ay.hi, ax.hi), jnp.where(swap, ay.lo, ax.lo))
    th = _atan_core(num, den)

    hp = _df_const(PI_OVER_2)
    th_sw = add(neg(th), DF(jnp.full_like(th.hi, hp.hi),
                            jnp.full_like(th.lo, hp.lo)))
    th = DF(jnp.where(swap, th_sw.hi, th.hi),
            jnp.where(swap, th_sw.lo, th.lo))
    pi_df = _df_const(PI)
    th_neg = add(neg(th), DF(jnp.full_like(th.hi, pi_df.hi),
                             jnp.full_like(th.lo, pi_df.lo)))
    xneg = x.hi < 0
    th = DF(jnp.where(xneg, th_neg.hi, th.hi),
            jnp.where(xneg, th_neg.lo, th.lo))
    yneg = y.hi < 0
    return DF(jnp.where(yneg, -th.hi, th.hi),
              jnp.where(yneg, -th.lo, th.lo))


def atan(x: DF) -> DF:
    """arctan via the single-division table core (see :func:`_atan_core`);
    |x| > 1 is handled by the min/max swap instead of a reciprocal branch.
    """
    one = df(jnp.ones_like(x.hi))
    return atan2(x, one)
