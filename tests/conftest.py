"""Test harness configuration.

Tests run on an 8-device *virtual CPU mesh*: the environment must be set
before JAX initializes its backends. ``SMMC_TEST_ON_DEVICE=1`` switches
that CPU forcing off, so ``pytest -m gpu`` runs the GPU tests on the card
(chip_smoke.py sets it before it calls pytest in-process). Whether a GPU
is present is decided in the ``gpu`` fixture, never at import.
"""

import os

_ON_DEVICE = os.environ.get("SMMC_TEST_ON_DEVICE") == "1"

if not _ON_DEVICE:
    os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    # no persistent compile cache for CPU test runs (and the processes
    # they spawn): loading a cached XLA:CPU executable logs machine-feature
    # E-lines that tests/test_xla_warnings.py treats as unexpected
    os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the full suite including slow-tier tests "
             "(equivalent: SMMC_FULL=1)",
    )


def _slow_list():
    """tests/slow_tests.txt: nodeid prefixes of the slow tier (kept as a
    data file so re-tiering from a fresh ``--durations`` run never
    touches test code)."""
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return tuple(
                ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")
            )
    except OSError:
        return ()


def pytest_collection_modifyitems(config, items):
    """Tiered suite: the default ``pytest -q`` run skips tests marked
    ``slow`` or listed in tests/slow_tests.txt (mesh-heavy and large-grid
    variants) so build iterations are un-gated. ``--full`` /
    ``SMMC_FULL=1`` runs everything — the round-end check and CI-rigor
    runs use that. An explicit ``-m`` selection disables the tier
    filter entirely (the user asked for a specific marker set)."""
    if (config.getoption("--full") or os.environ.get("SMMC_FULL") == "1"
            or config.getoption("-m")):
        return
    slow = _slow_list()
    tier_skip = pytest.mark.skip(
        reason="tier: slow (run with --full or SMMC_FULL=1)"
    )
    for item in items:
        nid = item.nodeid
        if "slow" in item.keywords or any(
                nid == s or nid.startswith(s + "[") for s in slow):
            item.add_marker(tier_skip)


_skips = []


def pytest_runtest_logreport(report):
    if report.skipped and report.when in ("setup", "call"):
        reason = (report.longrepr[2]
                  if isinstance(report.longrepr, tuple)
                  else str(report.longrepr))
        _skips.append({"nodeid": report.nodeid,
                       "reason": reason.removeprefix("Skipped: ")})


def pytest_sessionfinish(session, exitstatus):
    """Skip accounting: with SMMC_SKIP_MANIFEST=1 the run writes
    SKIPS.json at the repo root — every skipped test and its reason — so
    a pass->skip regression is visible between runs."""
    if os.environ.get("SMMC_SKIP_MANIFEST") != "1":
        return
    path = os.path.join(_REPO, "SKIPS.json")
    with open(path, "w") as f:
        json.dump({
            "collected": session.testscollected,
            "exitstatus": int(exitstatus),
            "n_skipped": len(_skips),
            "skips": sorted(_skips, key=lambda d: d["nodeid"]),
        }, f, indent=1)
        f.write("\n")


@pytest.fixture(scope="session")
def historical_table():
    from stock_market_monte_carlo_jax.data.loader import (
        SYNTHETIC_CSV,
        read_historical_returns,
    )

    return read_historical_returns(SYNTHETIC_CSV)


@pytest.fixture(scope="session")
def mesh8():
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices("cpu")[:8])
    assert devices.size == 8, "expected 8 virtual CPU devices"
    return Mesh(devices, ("paths",))


@pytest.fixture(scope="session")
def gpu():
    """The first device, when it is a GPU; otherwise the test skips."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform}); run "
                    "`SMMC_TEST_ON_DEVICE=1 python -m pytest -m gpu tests/` "
                    "on one")
    return dev
