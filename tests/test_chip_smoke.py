"""chip_smoke.py: it refuses a CPU, and its phase functions run end to
end at a tiny size on the CPU (the same code the GPU run executes at the
reference's full size)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

N, T = 1 << 20, 12


def _run_script(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_cpu():
    out = _run_script(REPO, {"PYTHONPATH": REPO})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def main_runs():
    return cs.phase_main(n=N, t=T)


def test_phase_main(main_runs, capsys):
    assert set(main_runs) == set(cs.MAIN_RUNS)
    for first, second in main_runs.values():
        assert second.moments.n == N
        assert cs.close_result(first, second)


@pytest.mark.parametrize("check", [
    "gaussian_moments", "historical_mean", "per_path", "terminal_law",
    "histogram", "cpu_vs_device", "precision",
])
def test_phase_compare(main_runs, check):
    if check == "gaussian_moments":
        cs.check_gaussian_moments(main_runs["gaussian_month"][1], N, T)
    elif check == "historical_mean":
        cs.check_historical_mean(main_runs["historical_month"][1],
                                 cs.historical(), N, T)
    elif check == "per_path":
        cs.check_per_path(1 << 14, T)
    elif check == "terminal_law":
        cs.check_terminal_law(1 << 18, T)
    elif check == "histogram":
        cs.check_histogram(1 << 16, T)
    elif check == "cpu_vs_device":
        cs.check_cpu_vs_device(1 << 14, T)
    else:
        cs.check_precision()


def test_phase_determinism(main_runs):
    cs.phase_determinism(main_runs, n=N, t=T)


def test_phase_trace():
    cs.phase_trace(n=1 << 16, t=T)


def test_phase_four_chips(mesh8):
    cs.phase_four_chips(4, n_law=1 << 18, n=1 << 17, t=T)


def test_large_buffers_reads_unfused_computations_only():
    hlo = "\n".join([
        "%fused_computation.1 (p: f32[4,8]) -> f32[4,8] {",
        "  %x = f32[4,8]{1,0} multiply(%p, %p)",
        "}",
        "ENTRY %main.2 (a: f32[4,8]) -> (f32[4,8], s32[2]) {",
        "  %fusion.3 = f32[4,8]{1,0} fusion(%a), kind=kLoop",
        "  %small = s32[2]{0} iota(), iota_dimension=0",
        "  ROOT %t = (f32[4,8]{1,0}, s32[2]{0}) tuple(%fusion.3, %small)",
        "}",
    ])
    got = cs.large_buffers(hlo, 16)
    assert ("fusion.3", "fusion", "f32[4,8]") in got
    assert all(name != "x" for name, _, _ in got)
    assert all("s32" not in ty for _, _, ty in got)
