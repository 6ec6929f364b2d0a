import jax
import jax.numpy as jnp
import numpy as np

from stock_market_monte_carlo_jax.ops import normal as nm


def _phi_ref(x):
    from math import erfc, sqrt

    return np.array([0.5 * erfc(-v / sqrt(2)) for v in np.atleast_1d(x)])


def test_normal_cdf_matches_erfc_reference():
    x = np.linspace(-6, 6, 241)
    got = np.asarray(nm.normal_cdf(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, _phi_ref(x), atol=2e-7)


def test_abramowitz_stegun_port_accuracy():
    # A&S 26.2.17 claims |eps| < 7.5e-8 in exact arithmetic; the reference
    # uses this polynomial (benchmark_mc_gpu_reduceBlock.cpp:33-52). We run
    # it in float32 (x64 is off), so allow a few f32 ulps on top.
    x = np.linspace(-6, 6, 241)
    got = np.asarray(
        nm.normal_cdf_abramowitz_stegun(jnp.asarray(x, jnp.float32))
    )
    np.testing.assert_allclose(got, _phi_ref(x), atol=7e-7)


def test_icdf_roundtrip():
    u = np.linspace(1e-6, 1 - 1e-6, 1001)
    z = np.asarray(nm.normal_icdf(jnp.asarray(u, jnp.float32)))
    u2 = np.asarray(nm.normal_cdf(jnp.asarray(z)))
    np.testing.assert_allclose(u2, u, atol=3e-6)


def test_icdf_tails_finite():
    z = np.asarray(nm.normal_icdf(jnp.asarray([0.0, 1.0], jnp.float32)))
    assert np.all(np.isfinite(z))
    assert z[0] < -5 and z[1] > 5


def test_erfinv_against_erf():
    x = np.linspace(-0.999, 0.999, 501)
    y = np.asarray(nm.erfinv_f32(jnp.asarray(x, jnp.float32)))
    x2 = np.asarray(jax.lax.erf(jnp.asarray(y)))
    np.testing.assert_allclose(x2, x, atol=2e-6)


def test_icdf_maps_uniforms_to_standard_normal():
    u = jax.random.uniform(jax.random.key(0), (500_000,))
    z = np.asarray(nm.normal_icdf(u))
    assert abs(z.mean()) < 0.01
    assert abs(z.std() - 1.0) < 0.01
    # tail mass
    assert abs((z < -2.326).mean() - 0.01) < 0.002


def test_pdf_and_quantiles():
    assert np.isclose(float(nm.normal_pdf(0.0)), 0.3989423, atol=1e-6)
    q = np.asarray(nm.quantiles_from_mean_std([0.025, 0.5, 0.975], 10.0, 2.0))
    np.testing.assert_allclose(q, [10 - 1.95996 * 2, 10, 10 + 1.95996 * 2],
                               atol=1e-3)


def test_count_below_clt_matches_reference_semantics():
    # update_count_below_min: n * Phi((target-mean)/std)
    # (benchmark_mc_gpu_reduceBlock.cpp:65-70)
    got = float(nm.count_below_clt(1000.0, 5000.0, 2000.0, 1_000_000))
    want = 1_000_000 * _phi_ref((1000 - 5000) / 2000)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_truncated_cdf():
    full = float(nm.truncated_normal_cdf_left(2.0, 0.0, 1.0, -np.inf))
    assert np.isclose(full, _phi_ref(2.0)[0], atol=1e-6)
    t = float(nm.truncated_normal_cdf_left(0.0, 0.0, 1.0, 0.0))
    assert np.isclose(t, 0.0, atol=1e-6)
