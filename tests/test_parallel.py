import numpy as np
import pytest

from stock_market_monte_carlo_jax.parallel import device_count, paths_mesh


def test_paths_mesh_all_devices():
    mesh = paths_mesh()
    assert mesh is not None
    assert mesh.axis_names == ("paths",)
    assert mesh.size == device_count() == 8


def test_paths_mesh_single_returns_none():
    assert paths_mesh(1) is None


def test_paths_mesh_too_many_raises():
    with pytest.raises(ValueError, match="available"):
        paths_mesh(10_000)


def test_mesh_subset():
    mesh = paths_mesh(4)
    assert mesh.size == 4


def test_engine_with_helper_mesh():
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions
    from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

    res = smmc.simulate_stats(
        smmc.GaussianReturns(), 8 * KEY_TILE, 6, seed=0,
        options=EngineOptions(chunk_paths=KEY_TILE), mesh=paths_mesh(),
    )
    assert res.moments.n == 8 * KEY_TILE
    assert np.isfinite(res.mean)
