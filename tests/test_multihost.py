"""Multi-host evidence: a real 2-process ``jax.distributed`` CPU run.

parallel/mesh.py claims the engine runs unchanged over a process-spanning
mesh with only final statistics crossing DCN. This test proves it: two
OS processes each expose 4 virtual CPU devices, join a jax.distributed
cluster, build one 8-device global mesh, and run ``simulate_stats`` over
it. Both processes must report statistics identical to a single-process
8-device run (counter-based RNG makes the result topology-invariant).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

_WORKER = r"""
import json
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax

jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=pid)
import numpy as np
from jax.sharding import Mesh

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions

devs = jax.devices()
assert len(devs) == 4 * nproc, (len(devs), "global devices")
assert len(jax.local_devices()) == 4
mesh = Mesh(np.asarray(devs), ("paths",))
res = smmc.simulate_stats(
    smmc.GaussianReturns(), 16 * 8192, 12, seed=3, target_amount=1500.0,
    options=EngineOptions(chunk_paths=8192), mesh=mesh,
)
print("RESULT " + json.dumps({
    "mean": res.mean, "std": res.std,
    "count_below": res.count_below,
    "hist_mass": float(res.histogram_counts.sum()),
    "hist_head": [float(x) for x in
                  res.histogram_counts[np.nonzero(res.histogram_counts)[0][:5]]],
}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_mesh(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=4")
    env["XLA_FLAGS"] = " ".join(flags)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    keep = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + keep)

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        outs.append(json.loads(line[-1][len("RESULT "):]))

    # both processes see identical global statistics
    assert outs[0] == outs[1]

    # and they match a single-process 8-device run exactly (topology
    # invariance of the counter-based RNG; same per-device chunk shape)
    from jax.sharding import Mesh
    import jax

    devices = np.asarray(jax.devices("cpu")[:8])
    mesh = Mesh(devices, ("paths",))
    ref = smmc.simulate_stats(
        smmc.GaussianReturns(), 16 * KEY_TILE, 12, seed=3,
        target_amount=1500.0,
        options=EngineOptions(chunk_paths=KEY_TILE),
        mesh=mesh,
    )
    # the cross-process psum reassociates float32 sums, so stats agree to
    # collective rounding, not bit-exactly
    np.testing.assert_allclose(outs[0]["mean"], ref.mean, rtol=1e-6)
    np.testing.assert_allclose(outs[0]["std"], ref.std, rtol=2e-4)
    assert outs[0]["count_below"] == ref.count_below
    assert outs[0]["hist_mass"] == ref.histogram_counts.sum()
