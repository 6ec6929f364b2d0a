"""C++ runtime library tests (skipped when `make native` hasn't run)."""

import numpy as np
import pytest

from stock_market_monte_carlo_jax import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_csv_reader_parity_with_python(historical_table):
    from stock_market_monte_carlo_jax.data.loader import SYNTHETIC_CSV

    r = native.native_read_returns(SYNTHETIC_CSV)
    np.testing.assert_array_equal(r, historical_table)


def test_csv_reader_skips_garbage(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("Date,returns\n1928-01,\n1928-02,1.5\n1928-03,nan\n"
                 "1928-04,-2.25\n")
    np.testing.assert_allclose(
        native.native_read_returns(str(p)), [1.5, -2.25]
    )


def test_csv_reader_missing_column(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("Date,foo\n1,2\n")
    with pytest.raises(IOError):
        native.native_read_returns(str(p))


def test_writer_schema(tmp_path):
    p = tmp_path / "w.csv"
    ok = native.native_write_data_file(
        str(p),
        np.asarray([1.5, -2.0], np.float32),
        np.asarray([100.0, 101.5, 99.5], np.float32),
    )
    assert ok
    text = p.read_text()
    assert text.startswith("Returns,,1.5,-2,")
    assert "\nValues,100,101.5,99.5," in text


def test_sobol_cross_check_device_generator():
    """The C++ gray-code recurrence must reproduce the on-device
    random-access generator exactly (unscrambled)."""
    import jax.numpy as jnp

    from stock_market_monte_carlo_jax.ops import sobol as sb

    d = sb.direction_numbers(7)
    for offset in (0, 1, 1000, 123457):
        cpu = native.native_sobol_points(d, offset, 64)
        dev = np.asarray(
            sb.sobol_points_f32(jnp.asarray(d), jnp.uint32(offset), 64, 7)
        )
        np.testing.assert_allclose(cpu, dev, atol=1e-7), offset


def test_welford_merge_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(3, 2, 1000)
    b = rng.normal(5, 1, 2345)
    sa = np.asarray([a.size, a.mean(), ((a - a.mean()) ** 2).sum()])
    sb_ = np.asarray([b.size, b.mean(), ((b - b.mean()) ** 2).sum()])
    merged = native.native_welford_merge(sa.copy(), sb_)
    both = np.concatenate([a, b])
    assert merged[0] == both.size
    np.testing.assert_allclose(merged[1], both.mean(), rtol=1e-12)
    np.testing.assert_allclose(merged[2] / both.size, both.var(), rtol=1e-12)


def test_stale_library_missing_symbol_falls_back(monkeypatch):
    """Regression: a library missing newer symbols (AttributeError in
    _configure) must not break the native module — it falls back."""
    import importlib

    from stock_market_monte_carlo_jax import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LOAD_ATTEMPTED", False)

    def boom(lib):
        raise AttributeError("undefined symbol: smmc_sobol_bits64")

    monkeypatch.setattr(native, "_configure", boom)
    assert native._lib() is None
    assert native.available() is False
    assert native.native_read_returns("/nonexistent.csv") is None
    importlib.reload(native)  # restore real state for other tests
