import jax.numpy as jnp
import numpy as np
import pytest

from stock_market_monte_carlo_jax.ops import reductions as red


def test_packed_stats_and_merge_match_numpy():
    rng = np.random.default_rng(0)
    a = rng.lognormal(7, 1, 5000).astype(np.float32)
    b = rng.lognormal(7, 1, 3000).astype(np.float32)
    target = float(np.median(a))

    sa = np.asarray(red.packed_stats(jnp.asarray(a), target, None), np.float64)
    sb = np.asarray(red.packed_stats(jnp.asarray(b), target, None), np.float64)
    merged = np.asarray(red.merge_packed_stats(
        jnp.asarray(sa, jnp.float32), jnp.asarray(sb, jnp.float32)
    ))

    both = np.concatenate([a, b])
    m = red.MomentSummary.from_packed(np.asarray(merged, np.float64), True)
    assert m.n == 8000
    assert m.mean == pytest.approx(both.mean(), rel=1e-4)
    assert m.std == pytest.approx(both.std(), rel=1e-3)
    assert m.min == pytest.approx(both.min())
    assert m.max == pytest.approx(both.max())
    assert m.count_below == int((both < target).sum())


def test_moment_summary_skew_kurtosis():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, 400_000)
    s = np.zeros(red.N_STATS)
    s[0] = x.size
    s[1] = x.sum()
    s[2] = (x**2).sum()
    s[3] = (x**3).sum()
    s[4] = (x**4).sum()
    s[5], s[6] = x.min(), x.max()
    m = red.MomentSummary.from_packed(s, False)
    assert abs(m.skew) < 0.02
    assert m.kurtosis == pytest.approx(3.0, abs=0.05)


def test_welford_combine():
    rng = np.random.default_rng(2)
    a = rng.normal(5, 2, 1000)
    b = rng.normal(5, 2, 1777)
    sa = (np.float32(a.size), np.float32(a.mean()),
          np.float32(((a - a.mean()) ** 2).sum()))
    sb = (np.float32(b.size), np.float32(b.mean()),
          np.float32(((b - b.mean()) ** 2).sum()))
    n, mean, m2 = red.welford_combine(sa, sb)
    both = np.concatenate([a, b])
    assert float(n) == both.size
    assert float(mean) == pytest.approx(both.mean(), rel=1e-6)
    assert float(m2) / both.size == pytest.approx(both.var(), rel=1e-5)


def test_histogram_spec_counts_match_numpy():
    spec = red.HistogramSpec(lo=10.0, hi=1000.0, n_bins=64)
    rng = np.random.default_rng(3)
    x = rng.lognormal(4, 2, 20_000).astype(np.float32)
    counts = np.asarray(spec.count(jnp.asarray(x)))
    edges = spec.edges()
    want_interior, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(counts[1:-1], want_interior)
    assert counts[0] == (x < 10.0).sum()
    # np.histogram includes the right edge in the last bin; our overflow bin
    # is [hi, inf)
    assert counts[-1] == (x >= 1000.0).sum()
    assert counts.sum() == x.size


def test_histogram_zero_values_land_in_underflow():
    spec = red.HistogramSpec(lo=1.0, hi=100.0, n_bins=8)
    counts = np.asarray(spec.count(jnp.asarray([0.0, 0.0, 50.0])))
    assert counts[0] == 2


def test_quantiles_from_histogram_interpolation():
    spec = red.HistogramSpec(lo=1.0, hi=np.e**4, n_bins=1000)
    rng = np.random.default_rng(4)
    x = np.exp(rng.uniform(0, 4, 200_000)).astype(np.float32)
    counts = np.asarray(spec.count(jnp.asarray(x)), np.float64)
    got = red.quantiles_from_histogram(spec, counts, [0.1, 0.5, 0.9])
    want = np.quantile(x, [0.1, 0.5, 0.9])
    np.testing.assert_allclose(got, want, rtol=5e-3)


def test_exact_quantiles():
    x = jnp.asarray(np.arange(1, 102, dtype=np.float32))
    q = red.exact_quantiles(x, [0.0, 0.5, 1.0])
    np.testing.assert_allclose(q, [1, 51, 101])


def test_default_histogram_spec_brackets_analytic_range():
    spec = red.default_histogram_spec(1000.0, 360, 0.004, 0.05, 128)
    center = 1000.0 * np.exp(360 * 0.004)
    assert spec.lo < center < spec.hi
