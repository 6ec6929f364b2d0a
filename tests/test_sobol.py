import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.ops import sobol as sb


def test_primitive_polynomials_known_small_degrees():
    polys = sb.primitive_polynomials()
    by_degree = {}
    for p in polys.tolist():
        by_degree.setdefault(int(p).bit_length() - 1, []).append(int(p))
    # x^2+x+1 is the unique primitive polynomial of degree 2
    assert by_degree[2] == [0b111]
    # degree 3: x^3+x+1 (0b1011), x^3+x^2+1 (0b1101)
    assert by_degree[3] == [0b1011, 0b1101]
    # known counts: phi(2^d - 1) / d
    known = {2: 1, 3: 2, 4: 2, 5: 6, 6: 6, 7: 18, 8: 16, 9: 48, 10: 60}
    for d, c in known.items():
        assert len(by_degree[d]) == c, f"degree {d}"


def test_direction_numbers_shape_and_dim0():
    v = sb.direction_numbers(8)
    assert v.shape == (8, 32)
    assert v.dtype == np.uint32
    # dim 0 = van der Corput: v_k = 2^(31-k)
    np.testing.assert_array_equal(
        v[0], np.uint32(1) << (31 - np.arange(32, dtype=np.uint32))
    )


def test_each_dimension_is_a_0_1_sequence():
    """First 2^k unscrambled points of any dim are a permutation of
    {0, 1, ..., 2^k - 1} / 2^k — the defining (0,1)-net property."""
    dims = 6
    k = 10
    v = sb.direction_numbers(dims)
    pts = np.asarray(
        sb.sobol_points_f32(jnp.asarray(v), jnp.uint32(0), 1 << k, dims)
    )
    for d in range(dims):
        cells = np.floor(pts[:, d] * (1 << k)).astype(int)
        assert sorted(cells.tolist()) == list(range(1 << k)), f"dim {d}"


def test_random_access_matches_sequential():
    """Points at offset must equal the tail of points from 0 (skip-ahead)."""
    v = jnp.asarray(sb.direction_numbers(4))
    full = np.asarray(sb.sobol_points_f32(v, jnp.uint32(0), 256, 4))
    tail = np.asarray(sb.sobol_points_f32(v, jnp.uint32(100), 156, 4))
    np.testing.assert_array_equal(full[100:], tail)


def test_digital_shift_scrambling_preserves_uniformity():
    v = jnp.asarray(sb.direction_numbers(3))
    key = jax.random.key(42)
    a = np.asarray(sb.sobol_points_f32(v, jnp.uint32(0), 4096, 3, key))
    b = np.asarray(sb.sobol_points_f32(v, jnp.uint32(0), 4096, 3))
    assert not np.allclose(a, b)  # scrambling moved the points
    for d in range(3):
        cells = np.floor(a[:, d] * 4096).astype(int)
        # digital shift keeps the (0,1)-sequence property exactly
        assert sorted(cells.tolist()) == list(range(4096))


def test_sobol_beats_pseudorandom_convergence():
    """QMC error on a smooth integrand should beat MC at the same n.

    Integrand: product of (1 + (u-0.5)) over 8 dims, exact integral 1.
    """
    dims, n = 8, 1 << 12
    v = jnp.asarray(sb.direction_numbers(dims))
    pts = np.asarray(
        sb.sobol_points_f32(v, jnp.uint32(0), n, dims, jax.random.key(1))
    )
    qmc_est = np.prod(1 + (pts - 0.5), axis=1).mean()

    mc_errs = []
    for s in range(8):
        u = np.asarray(
            jax.random.uniform(jax.random.key(100 + s), (n, dims))
        )
        mc_errs.append(abs(np.prod(1 + (u - 0.5), axis=1).mean() - 1.0))
    mc_err = np.median(mc_errs)
    assert abs(qmc_est - 1.0) < mc_err / 3


def test_sobol_gaussian_model_end_to_end():
    m = smmc.SobolGaussianReturns.create(
        n_periods=24, mean_pct=0.5, std_pct=1.0
    )
    res = smmc.simulate_stats(m, 65_536, 24, seed=7)
    mean_a = 1000.0 * (1 + 0.5 / 100) ** 24
    # QMC at 64k paths nails the mean far tighter than MC would
    assert abs(res.mean - mean_a) / mean_a < 2e-4


def test_sobol_historical_model(historical_table):
    m = smmc.SobolHistoricalBootstrap.create(
        jnp.asarray(historical_table), n_periods=12
    )
    res = smmc.simulate_stats(m, 16_384, 12, seed=3)
    g = (100 + historical_table.astype(np.float64)) / 100
    mean_a = 1000.0 * g.mean() ** 12
    assert abs(res.mean - mean_a) / mean_a < 1e-3


def test_sobol_dims_limit():
    with pytest.raises(ValueError, match="dims"):
        sb.direction_numbers(100_000)


# ---------------------------------------------------------------------------
# 64-bit sequence depth (i8_sobol parity: 2^62 indices,
# reference include/sobol/sobol.cpp:14191)
# ---------------------------------------------------------------------------


def test_direction_tables_consistent():
    """The 32-bit table is exactly the top-32 bits of the first 32 columns
    of the 64-bit table, so deep indexing extends the same sequence."""
    v32 = sb.direction_numbers(16)
    v64 = sb.direction_numbers_u64(16)
    np.testing.assert_array_equal(
        v32, (v64[:, :32] >> np.uint64(32)).astype(np.uint32)
    )


def test_sobol_bits64_matches_32bit_at_low_indices():
    hi32 = sb.direction_numbers_hi32(8)
    idx = np.arange(500, dtype=np.uint32)
    b64 = np.asarray(sb.sobol_bits64(
        jnp.asarray(hi32), jnp.asarray(idx), jnp.zeros_like(idx)
    ))
    b32 = np.asarray(sb.sobol_bits(
        jnp.asarray(sb.direction_numbers(8)), jnp.asarray(idx)
    ))
    np.testing.assert_array_equal(b64, b32)


@pytest.mark.parametrize("offset", [(1 << 31) + 7, (1 << 33) + 12345,
                                    (1 << 45) + 999])
def test_sobol_bits64_matches_native_beyond_32bit(offset):
    """Device fold at >2^31 / >2^32 offsets vs the C++ 64-bit generator."""
    from stock_market_monte_carlo_jax import native

    if not native.available():
        pytest.skip("native library not built")
    dims, n = 6, 64
    v64 = sb.direction_numbers_u64(dims)
    want = native.native_sobol_bits64(v64, offset, n)
    lo, hi = sb._split_index64(offset, jnp.uint32(0), n)
    got = np.asarray(sb.sobol_bits64(
        jnp.asarray(sb.direction_numbers_hi32(dims)), lo, hi
    ))
    np.testing.assert_array_equal(
        got, (want >> np.uint64(32)).astype(np.uint32)
    )


def test_f64_host_points_match_native():
    from stock_market_monte_carlo_jax import native

    if not native.available():
        pytest.skip("native library not built")
    dims, n, offset = 4, 32, (1 << 40) + 3
    pts = sb.sobol_points_f64_host(dims, offset, n)
    bits = native.native_sobol_bits64(
        sb.direction_numbers_u64(dims), offset, n
    )
    np.testing.assert_allclose(
        pts, bits.astype(np.float64) * 2.0**-64, rtol=0, atol=0
    )


def test_deep_index_engine_xla_end_to_end():
    """A model positioned past 2^33 runs and matches direct point gen."""
    off = (1 << 33) + 54321
    m = smmc.SobolGaussianReturns.create(12, index_offset=off)
    res = smmc.simulate_stats(m, 8192, 12, seed=0)
    assert np.isfinite(res.mean) and res.mean > 0
    # direct check: the model's uniforms equal sobol_points_f32 at the
    # same 64-bit positions
    u_direct = np.asarray(sb.sobol_points_f32(
        sb.direction_numbers_hi32(12), jnp.uint32(0), 16, 12,
        index_offset=off,
    ))
    hi32 = sb.direction_numbers_hi32(12)
    lo, hi = sb._split_index64(off, jnp.uint32(0), 16)
    bits = np.asarray(sb.sobol_bits64(jnp.asarray(hi32), lo, hi))
    np.testing.assert_allclose(
        u_direct, bits.astype(np.float64) * 2.0**-32, rtol=1e-6
    )


def test_deep_index_validation():
    m = smmc.SobolGaussianReturns.create(4, index_offset=(1 << 62) - 4096)
    with pytest.raises(ValueError, match="2\\^62"):
        smmc.simulate_stats(m, 8192, 4)
    with pytest.raises(ValueError, match="direction table"):
        sb.sobol_points_f32(sb.direction_numbers(4), jnp.uint32(0), 8, 4,
                            index_offset=123)


def test_tau_sobol_reference_table():
    """Bratley-Fox favorable-seed table (ref: sobol.cpp:28467-28560)."""
    from stock_market_monte_carlo_jax.ops.sobol import (
        favorable_index_offset,
        tau_sobol,
    )

    assert [tau_sobol(d) for d in range(1, 14)] == [
        0, 0, 1, 3, 5, 8, 11, 15, 19, 23, 27, 31, 35
    ]
    assert tau_sobol(0) == -1 and tau_sobol(14) == -1
    assert favorable_index_offset(3) == 1 << 3   # tau=1, K=tau+dim-1=3
    assert favorable_index_offset(13) == 1 << 47
    assert favorable_index_offset(100) == 0


def test_sobol_points_f64_device_matches_host():
    """On-device f64 points (sobol_points_f64) must be BIT-identical to
    the host generator at the same 64-bit positions — incl. across the
    2^32 index-word boundary — and raise without x64 enabled."""
    import jax

    dims, n = 7, 64
    for offset in (0, 1 << 35):
        want = sb.sobol_points_f64_host(dims, offset, n)
        with jax.enable_x64(True):
            got = np.asarray(sb.sobol_points_f64(
                dims, jnp.uint32(0), n, index_offset=offset
            ))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float64

    with pytest.raises(ValueError, match="enable_x64"):
        sb.sobol_points_f64(dims, jnp.uint32(0), n)


def test_sobol_points_f64_scramble():
    """Scrambled f64 points: zero key == raw sequence; a real key keeps
    every 1-D projection a (0,1)-sequence (here: mean preserved) while
    changing the points."""
    import jax

    dims, n = 3, 256
    with jax.enable_x64(True):
        raw = np.asarray(sb.sobol_points_f64(dims, jnp.uint32(0), n))
        zero = np.asarray(sb.sobol_points_f64(
            dims, jnp.uint32(0), n,
            scramble_key=jax.random.wrap_key_data(
                np.zeros(2, np.uint32)),
        ))
        scr = np.asarray(sb.sobol_points_f64(
            dims, jnp.uint32(0), n, scramble_key=jax.random.key(7),
        ))
    np.testing.assert_array_equal(zero, raw)
    assert not np.array_equal(scr, raw)
    assert (scr >= 0).all() and (scr < 1).all()
    # digital shift preserves net equidistribution: mean of a full
    # power-of-two block stays (1/2 - 2^-65)-ish per dim
    np.testing.assert_allclose(scr.mean(axis=0), 0.5, atol=2e-3)
