"""bench.py --mesh N: the multi-device benchmark path, validated on the
virtual 8-device CPU mesh.

The numbers a CPU-mesh run produces are meaningless; the CONTRACT under
test is the plumbing — ``python bench.py <paths> <periods> --mesh 8``
must run every workload sharded over ``paths_mesh(8)`` end-to-end and
emit one BENCH-shaped JSON line with ``n_chips == 8`` — so a
multi-GPU row is one command on real devices.
Reference surface: the multi-GPU launcher benchmark invocation
``benchmark_mc_gpu <n_gpus> ...`` (/root/reference/src/simulations.cu:
576-655, examples/benchmark_mc_gpu.cpp:44-61).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_bench_mesh_8_cpu_plumbing():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "500000", "12", "--mesh", "8"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    d = json.loads(line)
    # BENCH shape: the driver's contract
    assert d["metric"] == (
        "paths_per_sec_per_chip_360mo_historical_exact_law_hist")
    assert d["unit"] == "paths/s/chip"
    assert d["value"] > 0
    ex = d["extra"]
    assert ex["n_chips"] == 8
    assert ex["n_paths"] == 500000 and ex["n_periods"] == 12
    # every workload ran: the five headline/month-loop elapsed fields
    for f in ("elapsed_s_historical_terminal_law",
              "elapsed_s_historical_terminal_law_statsonly",
              "elapsed_s_gaussian_terminal_law",
              "elapsed_s_historical_month_loop",
              "elapsed_s_gaussian_icdf"):
        assert ex[f] > 0, f
    # statistics flowed through the mesh merge (sanity, not accuracy)
    assert ex["historical_mean"] > 0
    assert ex["mean_rel_err_vs_analytic_icdf"] < 0.05
