"""Pins the known-benign XLA-CPU algebraic-simplifier warning.

CPU compiles of the terminal-law sampler's unrolled 48-term Clenshaw
chain may log ``algebraic_simplifier.cc ... circular simplification
loop`` — a bounded safety-valve rerun cap of the simplifier, numerically
inert.

These tests keep that diagnosis honest:
  1. the repro chain still compiles to results bit-exact vs an eager
     float32 replica (the capped simplifier output is correct), and
  2. the production law path's compile emits NO glog error lines other
     than the known benign pattern — if a jax upgrade starts emitting
     anything new on this path, this fails and the new error gets
     triaged instead of scrolling by in CI.
"""

import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENIGN_RE = re.compile(
    r"algebraic_simplifier.*circular simplification loop")
# glog error lines: "E0819 17:54:06.121679  4859 file.cc:123] ..."
GLOG_ERR_RE = re.compile(r"^E\d{4} ")


def _run_cpu(code: str) -> subprocess.CompletedProcess:
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_PLATFORM_NAME="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=600, cwd=REPO,
    )


def _unexpected_errors(stderr: str):
    return [ln for ln in stderr.splitlines()
            if GLOG_ERR_RE.match(ln) and not BENIGN_RE.search(ln)]


def test_clenshaw_simplifier_output_is_bit_exact():
    """The 50-rerun-capped simplifier must still produce the chain's
    exact float32 result (sequential evaluation order)."""
    proc = _run_cpu(
        "import jax, jax.numpy as jnp, numpy as np\n"
        "def f(law):\n"
        "    s = jnp.full((8, 128), 0.3, jnp.float32)\n"
        "    two_s = 2.0 * s\n"
        "    b1 = b2 = jnp.zeros((8, 128), jnp.float32)\n"
        "    for k in range(47, 0, -1):\n"
        "        b0 = two_s * b1 - b2 + law[1 + k]\n"
        "        b2, b1 = b1, b0\n"
        "    return law[0] * jnp.exp(s * b1 - b2 + law[1])\n"
        "law = jnp.linspace(0.1, 0.9, 49, dtype=jnp.float32)\n"
        "out = np.asarray(jax.jit(f)(law))\n"
        "print('RESULT', out.view(np.uint32)[0, 0], out[0, 0])\n"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = re.search(r"RESULT (\d+)", proc.stdout)
    assert m, proc.stdout

    # eager float32 replica with the same evaluation order
    law = np.linspace(0.1, 0.9, 49, dtype=np.float32)
    s = np.float32(0.3)
    two_s = np.float32(2.0) * s
    b1 = b2 = np.float32(0.0)
    for k in range(47, 0, -1):
        b0 = two_s * b1 - b2 + law[1 + k]
        b2, b1 = b1, b0
    want = np.float32(law[0] * np.exp(s * b1 - b2 + law[1]))
    assert int(m.group(1)) == int(want.view(np.uint32))
    assert not _unexpected_errors(proc.stderr), proc.stderr[-2000:]


def test_law_path_compile_has_no_unexpected_xla_errors():
    """The production terminal-law chunk program (engine._law_finals_xla
    through simulate_stats) must emit no glog error line beyond the
    pinned benign pattern."""
    proc = _run_cpu(
        "import stock_market_monte_carlo_jax as smmc\n"
        "from stock_market_monte_carlo_jax.config import EngineOptions\n"
        "r = smmc.simulate_stats(smmc.GaussianReturns(), 8192, 4,\n"
        "    target_amount=2000.0, options=EngineOptions(\n"
        "    terminal_law=True, chunk_paths=8192))\n"
        "print('HIST_SUM', float(r.histogram_counts.sum()))\n"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "HIST_SUM 8192.0" in proc.stdout, proc.stdout
    bad = _unexpected_errors(proc.stderr)
    assert not bad, "unexpected XLA error lines:\n" + "\n".join(bad)
