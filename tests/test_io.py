import numpy as np

from stock_market_monte_carlo_jax.utils import io


def test_write_data_file_schema(tmp_path, capsys):
    # schema must match src/helpers.cpp:23-38: "Returns,," then comma-
    # terminated cells; newline; "Values," then cells.
    returns = [1.5, -2.0]
    values = [1000.0, 1015.0, 994.7]
    path = io.write_data_file(
        "t.csv", returns, values, out_dir=str(tmp_path) + "/"
    )
    text = open(path).read()
    lines = text.split("\n")
    assert lines[0].startswith("Returns,,")
    assert lines[1].startswith("Values,")
    assert lines[0].endswith(",")
    assert lines[1].endswith(",")
    out = capsys.readouterr().out
    assert "Writing data to csv file" in out


def test_write_read_roundtrip(tmp_path):
    returns = np.asarray([0.5, -1.25, 3.0], np.float32)
    values = np.asarray([100.0, 100.5, 99.2, 102.2], np.float32)
    path = io.write_data_file(
        "rt.csv", returns, values, out_dir=str(tmp_path) + "/",
        verbose=False,
    )
    r2, v2 = io.read_data_file(path)
    np.testing.assert_allclose(r2, returns, rtol=1e-5)
    np.testing.assert_allclose(v2, values, rtol=1e-5)


def test_write_vector_file(tmp_path):
    p = tmp_path / "v.csv"
    io.write_vector_file(str(p), [1.0, 2.5])
    assert p.read_text() == "1,2.5,"


def test_print_vector(capsys):
    io.print_vector([1.0, 2.0])
    out = capsys.readouterr().out
    assert out.startswith("v = [ ")
    assert "1.000" in out
