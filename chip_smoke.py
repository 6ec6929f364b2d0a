"""Smoke test of the simulator on one GPU: its main path at the reference's
full size, checked against plain references, in one process.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: the sharded path only

Phases (one GPU):
  1. main path — ``simulate_stats`` at 100M paths x 360 months (target
     2000, 4096-bin histogram): historical terminal law, historical month
     loop, historical month loop stats-only, Gaussian month loop, and the
     CLI's ``smmc benchmark-mc-gpu 1 360 100000000`` in-process;
  2. comparisons with plain references, each with its stated tolerance;
  3. determinism: repeat runs, fused against unfused dispatch, and a
     checkpointed run resumed halfway against an uninterrupted one;
  4. a profiler trace of one month-loop call and one terminal-law call:
     top device ops, device idle share, and whether the month loop's
     (B, 360) growth array is written out as a fusion of its own;
  5. ``pytest -m gpu tests/`` in this process.

Every result line carries the card's name and power limit. Any failure
exits non-zero. The script refuses to run where JAX finds no GPU. The
last line of standard output is one JSON object naming the devices.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import sys
import time

# the host CPU backend runs beside the GPU for the same-program check
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

import stock_market_monte_carlo_jax as smmc  # noqa: E402
from stock_market_monte_carlo_jax.config import EngineOptions  # noqa: E402
from stock_market_monte_carlo_jax.engine import engine as eng  # noqa: E402
from stock_market_monte_carlo_jax.ops import analytic  # noqa: E402
from stock_market_monte_carlo_jax.ops import histogram as hist_ops  # noqa
from stock_market_monte_carlo_jax.ops import reductions as red  # noqa: E402
from stock_market_monte_carlo_jax.utils.device import (  # noqa: E402
    device_record,
    gpu_name_and_power_limit,
)

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "outputs", "chip_smoke")
N_MAIN = 100_000_000
N_LAW = 1_000_000_000
T = 360
TARGET = 2000.0
V0 = 1000.0
SEED = 7
LAW = EngineOptions(terminal_law=True)
MONTH = EngineOptions()

CARD = "card=unknown"


def say(phase: str, **fields) -> None:
    body = " ".join(
        f"{k}={float(v)!r}" if isinstance(v, np.floating) else f"{k}={v}"
        for k, v in fields.items())
    print(f"[{phase}] {body} | {CARD}", flush=True)


# --- compile time and memory ----------------------------------------------

_COMPILE_S = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


jax.monitoring.register_event_duration_secs_listener(_on_duration)


def _peak_bytes(device=None):
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(fn):
    """(result, wall_s, compile_s, peak_bytes) of fn()."""
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    return out, wall, _COMPILE_S[0] - c0, _peak_bytes()


def _stats_fields(res):
    m = res.moments
    return dict(mean=repr(m.mean), std=repr(m.std),
                count_below=res.count_below, min=repr(m.min),
                max=repr(m.max))


# --- models and plain references ------------------------------------------

def historical():
    return smmc.HistoricalBootstrap.from_csv()


def table_growth_moments(model):
    g = 1.0 + np.asarray(model.returns_pct, np.float64) / 100.0
    return g.mean(), (g * g).mean()


def gaussian_closed_form(t: int):
    """(mean, std) of V_T for the default Gaussian market, exact."""
    return analytic.final_value_moments(0.5, 10 / 12, t, V0)


def same_result(a, b) -> bool:
    """Bitwise identity of two SimulationResults' statistics."""
    hist_eq = (a.histogram_counts is None and b.histogram_counts is None) or (
        np.array_equal(a.histogram_counts, b.histogram_counts))
    return bool(hist_eq and a.moments == b.moments)


def close_result(a, b, rtol: float = 1e-6) -> bool:
    """Histograms identical and moments within rtol (the bound that holds
    whatever order the device sums in)."""
    hist_eq = (a.histogram_counts is None and b.histogram_counts is None) or (
        np.array_equal(a.histogram_counts, b.histogram_counts))
    ma, mb = a.moments, b.moments
    return bool(hist_eq and a.count_below == b.count_below
                and abs(ma.mean / mb.mean - 1) <= rtol
                and abs(ma.std / mb.std - 1) <= rtol
                and ma.min == mb.min and ma.max == mb.max)


# --- phase 1: the main path -----------------------------------------------

MAIN_RUNS = {
    "historical_law": (historical, LAW),
    "historical_month": (historical, MONTH),
    "historical_month_statsonly": (
        historical, dataclasses.replace(MONTH, histogram=False)),
    "gaussian_month": (smmc.GaussianReturns, MONTH),
}


def phase_main(n: int = N_MAIN, t: int = T) -> dict:
    """Each run twice with the same seed: the first includes compilation,
    the second is the warm wall time. Returns {name: (first, second)}."""
    out = {}
    for name, (make_model, opts) in MAIN_RUNS.items():
        model = make_model()

        def run():
            return smmc.simulate_stats(model, n, t, initial_capital=V0,
                                       seed=SEED, target_amount=TARGET,
                                       options=opts)

        first, wall1, comp1, _ = timed(run)
        second, wall2, comp2, peak = timed(run)
        out[name] = (first, second)
        say(f"main.{name}", n_paths=n, n_periods=t,
            first_wall_s=f"{wall1:.4f}", compile_s=f"{comp1:.4f}",
            warm_wall_s=f"{wall2:.4f}", warm_compile_s=f"{comp2:.4f}",
            peak_bytes_in_use=peak, **_stats_fields(second))
    from stock_market_monte_carlo_jax.cli.main import main as cli_main

    def cli():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["benchmark-mc-gpu", "1", str(t), str(n)])
        return buf.getvalue()

    text, wall, comp, peak = timed(cli)
    m = re.search(r"mean: ([0-9.eE+-]+) \| std: ([0-9.eE+-]+)", text)
    assert m, text
    assert np.isfinite(float(m.group(1))) and float(m.group(1)) > 0, text
    say("main.cli_benchmark_mc_gpu", argv=f"1,{t},{n}",
        wall_s=f"{wall:.4f}", compile_s=f"{comp:.4f}",
        peak_bytes_in_use=peak, mean=m.group(1), std=m.group(2))
    return out


# --- phase 2: comparisons with plain references ---------------------------

def check_gaussian_moments(res, n: int, t: int) -> None:
    """Mean within 5 sigma/sqrt(n) of 1000*1.005^t (the sample mean's own
    MC error); std within 5e-3 of the closed form (the sample std's
    relative MC error is sqrt((kurtosis - 1) / 4n), ~8e-5 at 1e8 paths
    and ~8e-4 at 1e6 for this near-lognormal law, so 5e-3 holds from 1e6
    paths up)."""
    mean_a, std_a = gaussian_closed_form(t)  # mean_a = 1000 * 1.005^t
    d_mean = abs(res.mean - mean_a) / (std_a / np.sqrt(n))
    d_std = abs(res.std - std_a) / std_a
    ok = d_mean < 5 and d_std < 5e-3
    say("compare.gaussian_month_moments", mean=repr(res.mean),
        closed_form_mean=repr(mean_a), mean_dev_sigmas=f"{d_mean:.3f}",
        std_rel_dev=f"{d_std:.2e}", tol="mean<5sigma/sqrt(n),std<5e-3",
        ok=ok)
    assert ok


def check_historical_mean(res, model, n: int, t: int) -> None:
    """Mean within 5 sigma/sqrt(n) of v0 E[g]^t, the table's exact
    discrete mean (sigma from the exact second moment)."""
    m1, m2 = table_growth_moments(model)
    mean_a = V0 * m1**t
    sd_a = V0 * np.sqrt(m2**t - m1 ** (2 * t))
    d = abs(res.mean - mean_a) / (sd_a / np.sqrt(n))
    ok = d < 5
    say("compare.historical_month_mean", mean=repr(res.mean),
        exact_mean=mean_a, dev_sigmas=f"{d:.3f}",
        tol="5sigma/sqrt(n)", ok=ok)
    assert ok


def check_per_path(n: int = 1 << 20, t: int = T) -> None:
    """Per-path finals on the device against the float64 product of the
    same paths' growth draws (fetched from sample_growth). Tolerance 1e-4
    relative: t f32 roundings of the running product (t * 2^-24 = 2.1e-5
    at t=360) plus reassociation on the device."""
    model = historical()
    finals = smmc.simulate_final_values(model, n, t, initial_capital=V0,
                                        seed=SEED)
    root = jax.random.key(SEED)
    draw = jax.jit(eng.sample_growth, static_argnums=(4,))
    growth = np.asarray(draw(model, root, jax.random.fold_in(root, 0x50B0),
                             np.uint32(0), (n, t)), np.float64)
    want = V0 * np.prod(growth, axis=1)
    rel = np.max(np.abs(finals / want - 1.0))
    ok = rel < 1e-4
    say("compare.per_path_f64", n_paths=n, n_periods=t,
        max_rel_err=f"{rel:.3e}", tol="1e-4", ok=ok)
    assert ok


def _law_density_logv(values, cdf, x):
    """d CDF / d log V of the FFT law at x (central difference)."""
    logv = np.log(values)
    lx = np.log(x)
    h = 1e-3
    f = np.interp([lx - h, lx + h], logv, cdf)
    return (f[1] - f[0]) / (2 * h)


def check_terminal_law(n: int = N_LAW, t: int = T) -> None:
    """Terminal-law quantiles against the exact bootstrap FFT law down to
    p = 1e-5. The reference quantile is the same histogram inversion
    applied to the law's expected histogram (so binning cancels); the
    tolerance is 5 binomial sigmas of the empirical CDF at each quantile,
    sqrt(p(1-p)/n), mapped to a relative quantile error through the law's
    density in log V, plus 1e-6 for the law fit and the FFT grid."""
    model = historical()
    table = tuple(np.asarray(model.returns_pct, np.float64))
    values, cdf = analytic.bootstrap_final_value_distribution(table, t, V0)
    ps = [1e-5, 1e-4, 1e-3, 0.01, 0.5, 0.99, 1 - 1e-3, 1 - 1e-4, 1 - 1e-5]
    x_tail = float(analytic.quantiles_from_cdf(values, cdf, [1e-4])[0])

    def run():
        return smmc.simulate_stats(model, n, t, initial_capital=V0,
                                   seed=SEED + 1, target_amount=x_tail,
                                   options=LAW)

    res, wall, comp, peak = timed(run)
    spec = res.histogram_spec
    log_edges = np.linspace(spec.log_lo, spec.log_hi, spec.n_bins + 1)
    cdf_at = np.interp(log_edges, np.log(values), cdf, left=0.0, right=1.0)
    expected = np.diff(np.concatenate([[0.0], cdf_at, [1.0]]))
    q_ref = red.quantiles_from_histogram(spec, expected, ps)
    q_mc = red.quantiles_from_histogram(spec, res.histogram_counts, ps)
    worst = 0.0
    for p, qr, qm in zip(ps, q_ref, q_mc):
        g = _law_density_logv(values, cdf, qr)
        tol = 5 * np.sqrt(p * (1 - p) / n) / g + 1e-6
        rel = abs(qm / qr - 1)
        worst = max(worst, rel / tol)
        say("compare.terminal_law_quantile", p=p, mc=qm, law=qr,
            rel_err=f"{rel:.2e}", tol=f"{tol:.2e}",
            ok=rel <= tol)
    p_hat = res.count_below / n
    p_tol = 5 * np.sqrt(1e-4 * (1 - 1e-4) / n)
    say("compare.terminal_law_count_below", n_paths=n, target=x_tail,
        p_hat=p_hat, p=1e-4, tol=f"{p_tol:.2e}",
        wall_s=f"{wall:.4f}", compile_s=f"{comp:.4f}",
        peak_bytes_in_use=peak, ok=abs(p_hat - 1e-4) <= p_tol)
    assert worst <= 1.0, worst
    assert abs(p_hat - 1e-4) <= p_tol


def check_histogram(n: int = 1 << 24, t: int = T) -> None:
    """The histogram at n elements, bin indices from the historical month
    loop's real finals, against np.bincount of the same fetched indices:
    exact (integer counts below 2^24 are exact in f32)."""
    model = historical()
    spec = eng.make_histogram_spec(model, smmc.NoWithdrawal(), t, V0,
                                   MONTH.histogram_bins)
    finals = smmc.simulate_final_values(model, n, t, initial_capital=V0,
                                        seed=SEED)
    idx = jax.jit(spec.bin_index)(jax.numpy.asarray(finals))
    n_cells = spec.n_bins + 2
    count = jax.jit(hist_ops.histogram_counts, static_argnums=(1,))
    got = np.asarray(count(idx, n_cells))
    want = np.bincount(np.asarray(idx), minlength=n_cells)
    ok = np.array_equal(got, want)
    say("compare.histogram_vs_bincount", n_elements=n, n_bins=n_cells,
        ok=ok)
    assert ok


def _edge_distance(spec, values):
    """Distance in log space from each value to the nearest bin edge."""
    pos = (np.log(values) - spec.log_lo) / spec.width
    frac = pos - np.floor(pos)
    return np.minimum(frac, 1.0 - frac) * spec.width


def check_cpu_vs_device(n: int = 1 << 22, t: int = T) -> None:
    """The same program on the device and on the host CPU backend. Same
    threefry streams, so the moments agree to 1e-6 relative and per-path
    finals differ only by f32 rounding order (t roundings of the running
    product: at most t * 2^-24 relative). Histogram cells then differ only
    by bin-edge flips: every path binned differently must lie within that
    per-path difference (plus 2e-6 for the two backends' f32 log in
    bin_index) of a bin edge. The flip count itself is reported."""
    model = historical()
    cpu = jax.devices("cpu")[0]
    for name, opts in (("month", MONTH), ("law", LAW)):
        def run():
            return smmc.simulate_stats(model, n, t, initial_capital=V0,
                                       seed=SEED, target_amount=TARGET,
                                       options=opts, keep_final_values=True)

        dev = run()
        spec = dev.histogram_spec
        bd = np.asarray(jax.jit(spec.bin_index)(dev.final_values))
        with jax.default_device(cpu):
            host, wall, _, _ = timed(run)
            bh = np.asarray(jax.jit(spec.bin_index)(host.final_values))
        fd = np.asarray(dev.final_values, np.float64)
        fh = np.asarray(host.final_values, np.float64)
        rel = float(np.max(np.abs(fd / fh - 1.0)))
        moved = bd != bh
        far = int(np.sum(_edge_distance(spec, fh[moved]) > rel + 2e-6))
        flips = int(np.abs(dev.histogram_counts
                           - host.histogram_counts).sum() // 2)
        d_mean = abs(dev.mean / host.mean - 1)
        d_std = abs(dev.std / host.std - 1)
        ok = (d_mean <= 1e-6 and d_std <= 1e-6 and far == 0
              and rel <= t * 2.0**-24)
        say(f"compare.cpu_vs_device.{name}", n_paths=n,
            cpu_wall_s=f"{wall:.2f}", mean_rel=f"{d_mean:.2e}",
            std_rel=f"{d_std:.2e}", max_path_rel=f"{rel:.2e}",
            hist_flips=flips, flip_share=f"{flips / n:.2e}",
            rebinned_paths=int(moved.sum()), rebinned_far_from_edge=far,
            tol="moments<=1e-6,path<=t*2^-24,rebinned_near_edge", ok=ok)
        assert ok


_MATMUL_RE = re.compile(r"dot_general\(|\.matmul\(|\.dot\(|einsum\("
                        r"|[\w)\]]\s*@\s*[\w(]")


def matmul_sites():
    """(file, line_no, statement) of every matrix product in the
    device-path modules (engine/, ops/, models/): comments and decorators
    excluded, the statement followed to its closing parenthesis."""
    pkg = os.path.dirname(smmc.__file__)
    hits = []
    for sub in ("engine", "ops", "models"):
        for path in sorted(glob.glob(os.path.join(pkg, sub, "*.py"))):
            with open(path) as f:
                lines = [ln.split("#", 1)[0].strip() for ln in f]
            for i, code in enumerate(lines):
                if code.startswith("@") or not _MATMUL_RE.search(code):
                    continue
                stmt, depth, j = code, code.count("(") - code.count(")"), i
                while depth > 0 and j + 1 < len(lines):
                    j += 1
                    stmt += " " + lines[j]
                    depth += lines[j].count("(") - lines[j].count(")")
                hits.append((os.path.relpath(path, pkg), i + 1, stmt))
    return hits


def check_precision() -> None:
    """Every matrix product on the device path states
    precision=HIGHEST, so no float32 operand is truncated to TF32."""
    hits = matmul_sites()
    bad = [h for h in hits if "HIGHEST" not in h[2]]
    say("compare.precision", matmul_sites=len(hits),
        sites=";".join(f"{f}:{i}" for f, i, _ in hits) or "none",
        unchecked=len(bad), ok=not bad)
    assert not bad, bad


def phase_compare(main: dict, n: int = N_MAIN, t: int = T,
                  n_path: int = 1 << 20, n_law: int = N_LAW,
                  n_hist: int = 1 << 24, n_cpu: int = 1 << 22) -> None:
    check_gaussian_moments(main["gaussian_month"][1], n, t)
    check_historical_mean(main["historical_month"][1], historical(), n, t)
    check_per_path(n_path, t)
    check_terminal_law(n_law, t)
    check_histogram(n_hist, t)
    check_cpu_vs_device(n_cpu, t)
    check_precision()


# --- phase 3: determinism -------------------------------------------------

class _Stop(Exception):
    pass


def phase_determinism(main: dict, n: int = N_MAIN, t: int = T) -> None:
    """Bitwise identity is reported; the run fails only past the bound
    that holds whatever order the device sums in (identical histograms,
    moments to 1e-6)."""
    model = historical()
    for name in ("historical_month", "historical_law"):
        a, b = main[name]
        say(f"determinism.repeat.{name}", bit_identical=same_result(a, b))
        assert close_result(a, b)
    for name, opts in (("historical_month", MONTH),
                       ("historical_law", LAW)):
        unfused = smmc.simulate_stats(
            model, n, t, initial_capital=V0, seed=SEED,
            target_amount=TARGET,
            options=dataclasses.replace(opts, fuse_chunks=0))
        fused = main[name][1]
        say(f"determinism.fused_vs_unfused.{name}",
            bit_identical=same_result(fused, unfused))
        assert close_result(fused, unfused)
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "resume.ckpt.npz")
    for p in (ckpt, ckpt + ".tmp.npz"):
        if os.path.exists(p):
            os.remove(p)

    def stop_halfway(done, total):
        if done >= total // 2:
            raise _Stop

    try:
        smmc.simulate_stats(model, n, t, initial_capital=V0, seed=SEED,
                            target_amount=TARGET, options=MONTH,
                            checkpoint_path=ckpt, progress=stop_halfway)
        raise AssertionError("the run was not interrupted")
    except _Stop:
        pass
    resumed = smmc.simulate_stats(model, n, t, initial_capital=V0,
                                  seed=SEED, target_amount=TARGET,
                                  options=MONTH, checkpoint_path=ckpt)
    os.remove(ckpt)
    whole = main["historical_month"][1]
    say("determinism.checkpoint_resume.historical_month",
        bit_identical=same_result(resumed, whole))
    assert close_result(resumed, whole)


# --- phase 4: where the time goes -----------------------------------------

_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "XLA TraceMe",
                  "Source code", "Launch Stats", "Framework")


def reduce_trace(path: str, window_name: str = "smmc_traced_call",
                 top: int = 10) -> dict:
    """Device busy/idle and top ops from one .xplane.pb: busy is the union
    of the kernel intervals on the device's stream lines, the window the
    host span of the annotated call."""
    prof = jax.profiler.ProfileData.from_file(path)
    window = None
    intervals, by_op, line_names = [], {}, set()
    for plane in prof.planes:
        is_dev = plane.name.startswith("/device:")
        for line in plane.lines:
            if is_dev:
                line_names.add(line.name)
            for ev in line.events:
                if ev.name == window_name and not is_dev:
                    window = (ev.start_ns, ev.end_ns)
                if not is_dev or line.name.startswith(_DERIVED_LINES):
                    continue
                intervals.append((ev.start_ns, ev.end_ns))
                by_op[ev.name] = by_op.get(ev.name, 0.0) + ev.duration_ns
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if window is not None:
            s, e = max(s, window[0]), min(e, window[1])
            if e <= s:
                continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if window is None and intervals:
        window = (intervals[0][0], max(e for _, e in intervals))
    span = (window[1] - window[0]) if window else 0.0
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"window_ms": span / 1e6, "busy_ms": busy / 1e6,
            "idle_share": (1 - busy / span) if span else None,
            "top_ops_ms": [(k, v / 1e6) for k, v in ops],
            "device_lines": sorted(line_names)}


_HLO_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = (\(.*?\)|\S+)\s+"
                        r"([\w\-]+)\(")
_HLO_ARRAY = re.compile(r"(\w+)\[([\d,]*)\]")
# instructions that name a buffer without writing one
_ALIASING_OPS = ("parameter", "get-tuple-element", "tuple", "bitcast")


def large_buffers(hlo_text: str, min_elements: int):
    """(instruction, opcode, type) of every array of at least min_elements
    that an unfused computation of the module writes — what goes to
    device memory; values inside fused computations stay on chip."""
    out, comp = [], None
    for line in hlo_text.splitlines():
        head = _HLO_HEADER.match(line)
        if head and " = " not in line:
            comp = head.group(1)
            continue
        m = _HLO_INSTR.match(line)
        if (not m or comp is None or comp.startswith(("fused", "region"))
                or m.group(3) in _ALIASING_OPS):
            continue
        for dtype, dims in _HLO_ARRAY.findall(m.group(2)):
            size = int(np.prod([int(d) for d in dims.split(",") if d]))
            if size >= min_elements:
                out.append((m.group(1), m.group(3), f"{dtype}[{dims}]"))
    return out


def growth_buffers(b: int, t: int = T) -> tuple:
    """(buffers of >= b*t/2 elements, temp bytes) of the compiled
    single-chunk month-loop program: whether the (B, T) growth draws (or
    their bits or indices) are written to device memory."""
    model = historical()
    spec = eng.make_histogram_spec(model, smmc.NoWithdrawal(), t, V0,
                                   MONTH.histogram_bins)
    fn = eng._get_chunk_fn((model.kind, "counter"), "none", t, b, spec,
                           False, None)
    root = jax.random.key(SEED)
    f32 = np.float32
    compiled = fn.lower(model, smmc.NoWithdrawal(), root,
                        jax.random.fold_in(root, 0x50B0), f32(V0),
                        np.uint32(0), np.int32(b), f32(TARGET),
                        f32(0.0)).compile()
    mem = compiled.memory_analysis()
    temp = getattr(mem, "temp_size_in_bytes", None) if mem else None
    return large_buffers(compiled.as_text(), b * t // 2), temp


def phase_trace(n: int = N_MAIN, t: int = T) -> None:
    model = historical()
    for name, opts in (("historical_month", MONTH),
                       ("historical_law", LAW)):
        def run():
            return smmc.simulate_stats(model, n, t, initial_capital=V0,
                                       seed=SEED, target_amount=TARGET,
                                       options=opts)

        run()  # warm: nothing compiles inside the trace
        log_dir = os.path.join(OUT_DIR, f"trace_{name}")
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation("smmc_traced_call"):
                run()
        files = sorted(glob.glob(os.path.join(
            log_dir, "plugins", "profile", "*", "*.xplane.pb")))
        assert files, f"no trace written under {log_dir}"
        r = reduce_trace(files[-1])
        say(f"trace.{name}", window_ms=f"{r['window_ms']:.3f}",
            busy_ms=f"{r['busy_ms']:.3f}",
            idle_share=(None if r["idle_share"] is None
                        else f"{r['idle_share']:.4f}"),
            device_lines="/".join(r["device_lines"]))
        for op, ms in r["top_ops_ms"]:
            say(f"trace.{name}.top_op", op=op[:120], total_ms=f"{ms:.3f}")
    b = eng._xla_chunk_paths(t, MONTH)
    bufs, temp = growth_buffers(b, t)
    say("trace.growth_array", chunk_paths=b, buffers_ge_half_BxT=len(bufs),
        buffers=";".join(f"{i}:{op}:{ty}" for i, op, ty in bufs) or "none",
        temp_bytes=temp, growth_f32_bytes=b * t * 4)


# --- phase 5: the GPU tests -------------------------------------------------

def phase_pytest() -> None:
    import pytest

    os.environ["SMMC_TEST_ON_DEVICE"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-m", "gpu", os.path.join(REPO, "tests"), "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    say("pytest.gpu", rc=int(rc), wall_s=f"{time.perf_counter() - t0:.1f}")
    assert int(rc) == 0, f"pytest -m gpu returned {int(rc)}"


# --- four cards ------------------------------------------------------------

def phase_four_chips(n_chips: int = 4, n_law: int = N_LAW,
                     n: int = N_MAIN, t: int = T) -> None:
    """The sharded path: the 1e9-path terminal law and the 100M x 360
    historical month loop on paths_mesh(n_chips), each against the same
    seed on device 0. Streams are keyed by path, so histograms are
    identical; moments agree to 1e-6 relative."""
    from stock_market_monte_carlo_jax.parallel.mesh import paths_mesh

    mesh = paths_mesh(n_chips)
    model = historical()
    for name, n_run, opts in (("historical_law", n_law, LAW),
                              ("historical_month", n, MONTH)):
        def run(m=None):
            return smmc.simulate_stats(model, n_run, t, initial_capital=V0,
                                       seed=SEED, target_amount=TARGET,
                                       options=opts, mesh=m)

        one = run()
        one, wall1, _, _ = timed(run)
        sharded, wall_c, comp, _ = timed(lambda: run(mesh))
        sharded, wall_s, _, peak = timed(lambda: run(mesh))
        ok = close_result(sharded, one)
        say(f"mesh{n_chips}.{name}", n_paths=n_run, n_periods=t,
            one_device_wall_s=f"{wall1:.4f}",
            mesh_first_wall_s=f"{wall_c:.4f}", mesh_compile_s=f"{comp:.4f}",
            mesh_warm_wall_s=f"{wall_s:.4f}", peak_bytes_in_use_dev0=peak,
            hist_identical=bool(np.array_equal(sharded.histogram_counts,
                                               one.histogram_counts)),
            moments_bit_identical=sharded.moments == one.moments,
            mean_rel=f"{abs(sharded.mean / one.mean - 1):.2e}", ok=ok)
        assert ok


# --- entry -----------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs; "
              f"JAX found {len(devs)}", file=sys.stderr)
        return 2
    card = gpu_name_and_power_limit()
    print(f"nvidia-smi name,power.limit: {card}", flush=True)
    CARD = "card=" + (card or "unknown").replace("\n", "; ")
    flags = os.environ.get("XLA_FLAGS", "")
    print(f"jax {jax.__version__}; XLA_FLAGS={flags!r}"
          f"; devices={[d.device_kind for d in devs]}", flush=True)
    if args.chips == 4:
        phase_four_chips()
    else:
        main_runs = phase_main()
        phase_compare(main_runs)
        phase_determinism(main_runs)
        phase_trace()
        phase_pytest()
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
