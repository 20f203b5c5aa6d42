"""Double-float arithmetic accuracy tests (vs the float64 oracle).

These run on CPU where f32 ops are IEEE binary32, the same round-to-nearest
semantics a GPU uses for +,-,*,/,sqrt — the error-free transformations
therefore carry over to the device (chip_smoke.py checks the chain there).
"""

import numpy as np
import pytest

from auromat_tpu.ops import dfloat as dfl


def rand(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n)


class TestBasicOps:
    def test_from_to_f64(self):
        v = rand(1000, -6.5e6, 6.5e6, 0)
        x = dfl.from_f64(v)
        np.testing.assert_allclose(dfl.to_f64(x), v, rtol=2e-15)

    def test_add_sub(self):
        a = rand(1000, -1e6, 1e6, 1)
        b = rand(1000, -1e6, 1e6, 2)
        # compare against the exact sum of what the DF pairs represent:
        # after heavy cancellation the ~2^-48|a| input representation error
        # dominates any comparison against the float64 a+b itself
        ra = dfl.to_f64(dfl.from_f64(a))
        rb = dfl.to_f64(dfl.from_f64(b))
        s = dfl.to_f64(dfl.add(dfl.from_f64(a), dfl.from_f64(b)))
        np.testing.assert_allclose(s, ra + rb, rtol=1e-13, atol=1e-10)
        np.testing.assert_allclose(s, a + b, rtol=1e-11, atol=1e-8)
        d = dfl.to_f64(dfl.sub(dfl.from_f64(a), dfl.from_f64(b)))
        np.testing.assert_allclose(d, ra - rb, rtol=1e-13, atol=1e-10)

    def test_cancellation(self):
        # the whole point: differences of near-equal large numbers survive
        a = np.array([6378137.0 + 0.125])
        b = np.array([6378137.0])
        d = dfl.to_f64(dfl.sub(dfl.from_f64(a), dfl.from_f64(b)))
        np.testing.assert_allclose(d, [0.125], rtol=1e-10)

    def test_mul(self):
        a = rand(1000, -1e4, 1e4, 3)
        b = rand(1000, -1e4, 1e4, 4)
        p = dfl.to_f64(dfl.mul(dfl.from_f64(a), dfl.from_f64(b)))
        np.testing.assert_allclose(p, a * b, rtol=1e-13)

    def test_div(self):
        a = rand(1000, -1e4, 1e4, 5)
        b = rand(1000, 0.1, 1e4, 6)
        q = dfl.to_f64(dfl.div(dfl.from_f64(a), dfl.from_f64(b)))
        np.testing.assert_allclose(q, a / b, rtol=1e-13)

    def test_sqrt(self):
        a = rand(1000, 1e-3, 4e13, 7)
        s = dfl.to_f64(dfl.sqrt(dfl.from_f64(a)))
        np.testing.assert_allclose(s, np.sqrt(a), rtol=1e-13)

    def test_sqrt_zero_safe(self):
        """sqrt(DF(0,0)) must be exactly zero, not NaN (the Newton
        correction used to divide 0/0), and atan2(y, sqrt(0)) must hit
        +-pi/2 — the df64 georef clamps epsilon-negative s2 to exact df
        zero at |elevation| -> 90 deg, which silently exported 0 deg."""
        import numpy as np
        z = dfl.sqrt(dfl.DF(np.float32(np.zeros(4)), np.float32(np.zeros(4))))
        assert np.all(np.asarray(z.hi) == 0.0)
        assert np.all(np.asarray(z.lo) == 0.0)
        y = dfl.from_f64(np.array([1.0, -2.0, 3.0, -4.0]))
        ang = dfl.to_f64(dfl.atan2(y, z))
        np.testing.assert_allclose(
            ang, np.array([1, -1, 1, -1]) * np.pi / 2, atol=5e-13)

    def test_dot3(self):
        v = rand(300, -7000, 7000, 8).reshape(100, 3)
        w = rand(300, -1, 1, 9).reshape(100, 3)
        d = dfl.to_f64(dfl.dot3(
            dfl.from_f64(v[:, 0]), dfl.from_f64(v[:, 1]), dfl.from_f64(v[:, 2]),
            dfl.from_f64(w[:, 0]), dfl.from_f64(w[:, 1]), dfl.from_f64(w[:, 2]),
        ))
        expected = np.einsum("ij,ij->i", v, w)
        np.testing.assert_allclose(d, expected, rtol=1e-12, atol=1e-9)


class TestTranscendentals:
    def test_sincos(self):
        x = rand(2000, -6.0, 6.0, 10)
        s, c = dfl.sincos(dfl.from_f64(x))
        np.testing.assert_allclose(dfl.to_f64(s), np.sin(x), atol=2e-14)
        np.testing.assert_allclose(dfl.to_f64(c), np.cos(x), atol=2e-14)

    def test_atan(self):
        x = rand(2000, -50.0, 50.0, 11)
        a = dfl.to_f64(dfl.atan(dfl.from_f64(x)))
        np.testing.assert_allclose(a, np.arctan(x), atol=5e-13)

    def test_atan_small_and_large(self):
        x = np.concatenate([
            rand(200, -1e-4, 1e-4, 12), rand(200, 1e3, 1e6, 13),
            -rand(200, 1e3, 1e6, 14),
        ])
        a = dfl.to_f64(dfl.atan(dfl.from_f64(x)))
        np.testing.assert_allclose(a, np.arctan(x), atol=5e-13)

    def test_atan2_quadrants(self):
        ang = rand(2000, -np.pi + 1e-6, np.pi - 1e-6, 15)
        r = rand(2000, 0.1, 1e4, 16)
        y, x = r * np.sin(ang), r * np.cos(ang)
        a = dfl.to_f64(dfl.atan2(dfl.from_f64(y), dfl.from_f64(x)))
        np.testing.assert_allclose(a, np.arctan2(y, x), atol=5e-13)

    def test_accuracy_budget(self):
        """The parity budget: 1e-6 deg = 1.7e-8 rad. df64 atan must sit
        orders of magnitude below it."""
        x = rand(5000, -10, 10, 17)
        a = dfl.to_f64(dfl.atan(dfl.from_f64(x)))
        err = np.abs(a - np.arctan(x))
        # the table-reduced atan evaluates its r^3.. series in f32: ~2e-12
        # absolute, 3.5 orders below the 1.7e-8 rad parity budget (the old
        # df sincos series reached 1e-13 at ~10x the flops)
        assert err.max() < 5e-12


class TestXlaFoldingHazards:
    def test_add_constant_operand_under_jit(self):
        """XLA CPU folds the two_sum residual of add(df(const), y) —
        constants must ride as the SECOND operand. Guards the pattern the
        atan table reduction and the Bowring chain rely on."""
        import jax
        import jax.numpy as jnp

        x = rand(20000, 0.0, 1.0, 11)
        X = dfl.from_f64(x)
        t64 = dfl.to_f64(X)

        def den(t):
            k = jnp.clip(jnp.round(t.hi * 16.0), 0.0, 16.0)
            a = k * jnp.float32(1.0 / 16.0)
            d = dfl.add(dfl.mul(t, dfl.df(a)), dfl.df(jnp.ones_like(a)))
            return a, d.hi, d.lo

        a, hi, lo = jax.jit(lambda h, l: den(dfl.DF(h, l)))(X.hi, X.lo)
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        exact = 1.0 + t64 * np.asarray(a, np.float64)
        assert np.abs(got - exact).max() < 1e-13

    def test_atan_under_jit(self):
        import jax

        x = rand(20000, -20.0, 20.0, 12)
        X = dfl.from_f64(x)
        hi, lo = jax.jit(lambda h, l: tuple(dfl.atan(dfl.DF(h, l))))(X.hi, X.lo)
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert np.abs(got - np.arctan(x)).max() < 5e-12
