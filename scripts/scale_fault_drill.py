"""Device scale + fault drill (one GPU, a few minutes).

Exercises scale and checkpoint/resume for real rather than under
monkeypatch:

1. **Scale**: one 1e10-path terminal-law run and one 1e9-path month-loop
   run on the device — wall clock, paths/s, peak device memory. The 1e10 run
   dispatches ~596 chunks, exercising the deferred-absorb flush bound
   (`engine._DEFER_FLUSH_CHUNKS = 256`) twice over at the memory regime
   it exists for. (The reference claims "1B paths in a few seconds" on
   an RTX 3070, README.md:45-49 — this measures 10B.)
2. **Fault**: a 1e9-path month-loop run with checkpointing is SIGKILL'd
   mid-flight from outside (no Python cleanup), resumed, and the resumed
   statistics are asserted identical to an uninterrupted control —
   checkpoint/resume (engine/checkpoint.py) exercised by an actual
   process death. Only one process uses the device at a time: the parent
   touches no device until the child is dead.

Usage: python scripts/scale_fault_drill.py [--quick]
  --quick scales path counts down 10x.
Writes outputs/scale_fault_drill.json and prints a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CHILD = "__drill_child__"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "outputs")
RESULT = os.path.join(OUT_DIR, "scale_fault_drill.json")


def _mem_stats():
    import jax

    d = jax.local_devices()[0]
    try:
        m = d.memory_stats()
        return {"bytes_in_use": m.get("bytes_in_use"),
                "peak_bytes_in_use": m.get("peak_bytes_in_use")}
    except Exception:
        return {}


def scale_runs(quick: bool):
    import jax

    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions

    hist = smmc.HistoricalBootstrap.from_csv()
    out = {}

    # --- 1e10 terminal-law (full stats + 4096-bin histogram) ------------
    # ONE call: seed segmentation (EngineOptions.seed_segment_paths,
    # default 2^31) lifts the uint32 global-path-offset cap that used to
    # force splitting this run over three seeds — 1e10 paths runs as 5
    # seed segments whose statistics merge exactly in float64 on the
    # host. Fused dispatch (fuse_chunks=64) batches the ~598 chunks into
    # ~a dozen device dispatches.
    n_law = 10_000_000_000 // (10 if quick else 1)
    opts_law = EngineOptions(chunk_paths=2 ** 24, terminal_law=True)
    smmc.simulate_stats(hist, 2 ** 24, 360, seed=1, options=opts_law)  # warm
    # Warm-execute at the run's OWN shape so every fused scan length it
    # uses (full 64-blocks AND the exact-length tail block) is compiled
    # before the timed region.
    smmc.simulate_stats(hist, n_law, 360, seed=1, options=opts_law)
    t0 = time.perf_counter()
    r = smmc.simulate_stats(hist, n_law, 360, seed=7,
                            target_amount=2000.0, options=opts_law)
    dt = time.perf_counter() - t0
    chunks = -(-n_law // 2 ** 24)
    out["terminal_law_10B"] = {
        "n_paths": n_law, "n_periods": 360, "wall_s": round(dt, 3),
        "paths_per_s": round(n_law / dt, 1),
        "seed_segments": -(-n_law // (1 << 31)),
        "fuse_chunks": opts_law.fuse_chunks,
        "mean": round(r.mean, 2), "std": round(r.std, 2),
        "count_below_2000": int(r.count_below),
        "hist_sum": float(np.asarray(r.histogram_counts).sum()),
        "chunks": chunks,
        "defer_flushes": max(0, chunks // 256),
        "device_mem": _mem_stats(),
    }
    assert out["terminal_law_10B"]["hist_sum"] == n_law

    # --- 1e9 month-loop (the like-for-like reference workload) ----------
    n_ml = 1_000_000_000 // (10 if quick else 1)
    opts_ml = EngineOptions(chunk_paths=2 ** 24)
    smmc.simulate_stats(hist, 2 ** 24, 360, seed=1, options=opts_ml)  # warm
    t0 = time.perf_counter()
    res = smmc.simulate_stats(hist, n_ml, 360, seed=7,
                              target_amount=2000.0, options=opts_ml)
    dt = time.perf_counter() - t0
    out["month_loop_1B"] = {
        "n_paths": n_ml, "n_periods": 360, "wall_s": round(dt, 3),
        "paths_per_s": round(n_ml / dt, 1),
        "mean": round(res.mean, 2), "std": round(res.std, 2),
        "device_mem": _mem_stats(),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    return out


def compile_cache_dir():
    import jax

    return jax.config.jax_compilation_cache_dir


def _child_run(n_paths: int, ckpt: str):
    """Child process body: checkpointed 1e9 month-loop run, printing one
    progress line per absorbed chunk so the parent can time its kill."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions

    hist = smmc.HistoricalBootstrap.from_csv()

    def progress(done, total):
        # progress reports PATHS done; emit chunk indices for the parent
        print(f"CHUNK {done // 2 ** 24}/{-(-total // 2 ** 24)}", flush=True)

    res = smmc.simulate_stats(
        hist, n_paths, 360, seed=11, target_amount=2000.0,
        options=EngineOptions(chunk_paths=2 ** 24),
        checkpoint_path=ckpt, progress=progress,
    )
    print(f"DONE mean={res.mean}", flush=True)


def fault_drill(quick: bool):
    """SIGKILL a checkpointed run mid-flight; resume; compare.

    Warm-path resume: every process in the drill — the killed child, the
    resuming parent, and the control — shares the persistent compilation
    cache the package configures at import (utils/compile_cache), so the
    resume measures executable LOADING, not recompilation."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions

    n = 1_000_000_000 // (10 if quick else 1)
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "drill_run.ckpt.npz")
    for p in (ckpt, ckpt + ".tmp.npz"):
        if os.path.exists(p):
            os.remove(p)

    # child must be the ONLY device process while it runs: do not touch
    # jax here between spawn and kill (it leaves its compiled executables
    # in the shared compile cache for the resume to load)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), CHILD, str(n), ckpt],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO,
    )
    total = -(-n // 2 ** 24)
    killed_at = None
    for line in proc.stdout:
        if line.startswith("CHUNK"):
            done = int(line.split()[1].split("/")[0])
            if done >= max(2, total // 2):
                os.kill(proc.pid, signal.SIGKILL)  # no Python cleanup
                killed_at = done
                break
        elif line.startswith("DONE"):
            raise RuntimeError("child finished before the kill fired")
    proc.wait()
    assert killed_at is not None, "child produced no progress lines"
    assert os.path.exists(ckpt), "no checkpoint file survived the kill"

    t0 = time.perf_counter()
    resumed = smmc.simulate_stats(
        hist_model := smmc.HistoricalBootstrap.from_csv(), n, 360,
        seed=11, target_amount=2000.0,
        options=EngineOptions(chunk_paths=2 ** 24), checkpoint_path=ckpt,
    )
    resume_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    control = smmc.simulate_stats(
        hist_model, n, 360, seed=11, target_amount=2000.0,
        options=EngineOptions(chunk_paths=2 ** 24),
    )
    control_s = time.perf_counter() - t0

    identical_hist = bool(np.array_equal(
        np.asarray(resumed.histogram_counts),
        np.asarray(control.histogram_counts)))
    mean_rel = abs(resumed.mean - control.mean) / control.mean
    assert resumed.moments.n == n
    assert identical_hist, "resumed histogram != uninterrupted histogram"
    assert resumed.count_below == control.count_below
    assert mean_rel < 1e-12, mean_rel
    assert resumed.moments.min == control.moments.min
    assert resumed.moments.max == control.moments.max
    os.remove(ckpt)
    return {
        "n_paths": n, "chunks_total": total, "killed_after_chunk": killed_at,
        "kill": "SIGKILL (no cleanup)",
        "compile_cache": compile_cache_dir(),
        "resume_wall_s": round(resume_s, 3),
        "control_wall_s": round(control_s, 3),
        "resumed_equals_control": {
            "histogram": identical_hist,
            "mean_rel_diff": float(f"{mean_rel:.2e}"),
            "count_below": True, "min_max": True,
        },
    }


def main():
    if len(sys.argv) > 1 and sys.argv[1] == CHILD:
        _child_run(int(sys.argv[2]), sys.argv[3])
        return

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-fault", action="store_true",
                    help="re-measure the scale runs only (the fault "
                         "drill spawns/kills a child process and costs "
                         "several minutes)")
    args = ap.parse_args()

    out = {"quick": args.quick}
    if args.skip_fault:
        out["fault"] = None
    else:
        print("== fault drill (1e9 month-loop, SIGKILL + resume) ==",
              flush=True)
        out["fault"] = fault_drill(args.quick)
        print(json.dumps(out["fault"], indent=1))
    print("== scale runs ==", flush=True)
    out["scale"] = scale_runs(args.quick)
    print(json.dumps(out["scale"], indent=1))

    if out["fault"] is None and os.path.exists(RESULT):
        # --skip-fault re-measures scale only: keep the last fault result
        with open(RESULT) as f:
            prev = json.load(f)
        out["fault"] = prev.get("fault")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(RESULT, "w") as f:
        json.dump(out, f, indent=1)

    s, fj = out["scale"], out["fault"]
    law = s["terminal_law_10B"]
    ml = s["month_loop_1B"]
    print("\n| run | paths | wall | rate | peak device memory |")
    print("|---|---|---|---|---|")
    for name, r in (("terminal-law", law), ("month-loop", ml)):
        peak = r["device_mem"].get("peak_bytes_in_use")
        peak_s = f"{peak / 2**30:.2f} GiB" if peak else "n/a"
        print(f"| {name} x360 | {r['n_paths']:.1e} | {r['wall_s']} s | "
              f"{r['paths_per_s'] / 1e9:.2f} B/s | {peak_s} |")
    if fj:
        print(f"| kill+resume | {fj['n_paths']:.1e} | killed after chunk "
              f"{fj['killed_after_chunk']}/{fj['chunks_total']}, resumed "
              f"in {fj['resume_wall_s']} s | identical stats: "
              f"hist={fj['resumed_equals_control']['histogram']} | |")


if __name__ == "__main__":
    main()
