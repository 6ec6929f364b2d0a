"""Engine options and the compile-cache placement."""

import os
import subprocess
import sys

import pytest

from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("field,value", [("backend", "pallas"),
                                         ("gaussian_sampler", "clt")])
def test_engine_options_rejects_removed_fields(field, value):
    """The single engine has no backend choice and one Gaussian sampler:
    the removed knobs are refused, not silently ignored."""
    with pytest.raises(TypeError):
        EngineOptions(**{field: value})


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         "import stock_market_monte_carlo_jax, jax; "
         "print('DIR', jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split("DIR ", 1)[1].strip()


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_placement(env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set (the package sets nothing);
    unset, the cache is a fixed directory inside the checkout."""
    got = _cache_dir_in_child(env_dir)
    if env_dir is None:
        assert got == os.path.join(REPO, ".jax_cache")
        assert got == compile_cache.DEFAULT_DIR
    else:
        assert got == env_dir


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("terminal_law,histogram,tag", [
    (False, True, "xla/streams3/icdf"),
    (False, False, "xla/streams3/icdf/nohist"),
    (True, True, "xla/streams3/law"),
])
def test_checkpoint_stream_tag_unchanged(tmp_path, monkeypatch,
                                         terminal_law, histogram, tag):
    """Checkpoints written before the engine became XLA-only carry these
    stream tags in their fingerprint; they must keep resuming."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.engine import checkpoint as ckpt

    seen = []
    real = ckpt.config_fingerprint

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(ckpt, "config_fingerprint", spy)
    smmc.simulate_stats(
        smmc.GaussianReturns(), 8192, 6, seed=1,
        options=EngineOptions(chunk_paths=8192, terminal_law=terminal_law,
                              histogram=histogram),
        checkpoint_path=str(tmp_path / "run.ckpt.npz"))
    assert seen == [tag]


def test_device_record_names_the_devices():
    from stock_market_monte_carlo_jax.utils.device import device_record

    assert device_record() == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_gpu_name_is_none_without_nvidia_smi(monkeypatch):
    from stock_market_monte_carlo_jax.utils import device

    monkeypatch.setattr(device.shutil, "which", lambda name: None)
    assert device.gpu_name_and_power_limit() is None
