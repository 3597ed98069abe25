"""Headline benchmark: the reference's default workload — Cu-like FCC
32x32x32 cells = 131,072 atoms, LJ sigma=eps=1.0, 200 steps, cutoff 2.5,
skin 0.3, reneighbor every 20 (reference: parameter.c:27-50, README.md:60-62).

Metric: million atom-updates per second = 1e-6 * Natoms * ntimes / TOTAL
(reference: src/verletlist/main.c:337-338), on one GPU.

    python bench.py        # one JSON line: the headline, cluster scheme
    python bench.py --ab   # cluster kernels ilist_pl vs ilist, A B B A,
                           # end to end and force layer (profiler trace)

Refuses to run without a GPU: a CPU number is not a device number.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# Golden temperature trace for the EXACT benchmark workload, produced by
# building and running the C reference (binary stdout is the oracle, no
# code copied):
#   make TOOLCHAIN=GCC SIMD=NONE ENABLE_OPENMP=false
#   echo "nstat 10" > nstat10.conf
#   ./MDBench-VL-GCC-X86-DP -p nstat10.conf -n 200
# step -> temperature (DP). The bench gates the SP trajectory on these
# before printing a score: a fast-but-wrong kernel must FAIL here, not
# post a number.
GOLDEN_TEMP_131K = {
    20: 6.895877e-01, 40: 6.637927e-01, 60: 8.179967e-01,
    80: 8.584812e-01, 100: 8.200911e-01, 120: 8.084264e-01,
    140: 8.014512e-01, 160: 7.924040e-01, 180: 7.959717e-01,
    200: 7.961535e-01,
}


def golden_errors(temps, reneigh_every: int) -> dict:
    """step -> relative temperature error against the golden trace, at
    the reneighbor-boundary steps the run recorded."""
    out = {}
    for step, t_gold in GOLDEN_TEMP_131K.items():
        if step % reneigh_every == 0 and step <= len(temps):
            out[step] = abs(float(temps[step - 1]) - t_gold) / abs(t_gold)
    return out


def check_golden(temps, reneigh_every: int) -> dict:
    """Assert the run's temperature at reneighbor boundaries against the
    DP golden trace. SP trajectories decorrelate from DP over time
    (chaotic dynamics), but temperature is an N-averaged aggregate, so
    early steps must match tightly and late steps within SP drift.
    Returns the relative errors."""
    errs = golden_errors(temps, reneigh_every)
    if len(errs) != len(GOLDEN_TEMP_131K):
        raise SystemExit(
            f"GOLDEN GATE FAILED: {len(temps)} steps recorded, the gate "
            "needs all 200"
        )
    for step, rel in errs.items():
        tol = 1e-3 if step <= 60 else 2e-2
        if not rel < tol:
            raise SystemExit(
                f"GOLDEN GATE FAILED at step {step}: temp "
                f"{float(temps[step - 1]):.6e} vs golden "
                f"{GOLDEN_TEMP_131K[step]:.6e} (rel {rel:.2e} > tol "
                f"{tol:.0e}) — refusing to report a benchmark score for "
                "a wrong trajectory"
            )
    return errs


def card_info() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card.
    nvidia-smi stays off JAX, so it may run beside the JAX process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpu() -> dict:
    """The device as JAX reports it; exits non-zero unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX reports {len(devs)} x {devs[0].platform}; "
            "this benchmark measures the GPU only"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


SCOPES = ("force", "reneighbor")  # the engines' jax.named_scope spans


def _scope_of_ops(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> the first of SCOPES on its op_name path
    (from the compiled module's metadata), for the instructions that
    lie inside one."""
    out = {}
    pat = re.compile(r'%?([\w.\-]+) = .*metadata=\{[^}]*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        path = m.group(2).split("/")
        for sc in SCOPES:
            if sc in path:
                out[m.group(1)] = sc
                break
    return out


def trace_scopes(compiled, make_args, reps: int = 1,
                 trace_dir: str | None = None) -> dict:
    """Run `compiled(*make_args())` once under jax.profiler and reduce
    the GPU device events: per-call device seconds inside each named
    scope of SCOPES and outside them, busy seconds, the window from the
    first device event to the last, and the idle share (1 - busy /
    window). `reps` divides every time (calls inside the program).
    XLA may fuse several ops into one CUDA graph ("command_buffer"),
    which then counts as outside every scope: run with
    XLA_FLAGS=--xla_gpu_enable_command_buffer= for a full attribution."""
    import jax
    from jax.profiler import ProfileData

    args = make_args()
    jax.block_until_ready(args)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="trace_")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(*args))
    scope_of = _scope_of_ops(compiled.as_text())
    path = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    ))[-1]
    t = {sc: 0.0 for sc in SCOPES}
    t["other"] = 0.0
    per_op: dict[str, float] = {}
    t0, t1 = float("inf"), 0.0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue
                op = str(stats["hlo_op"])
                t[scope_of.get(op, "other")] += ev.duration_ns
                per_op[op] = per_op.get(op, 0.0) + ev.duration_ns
                t0 = min(t0, ev.start_ns)
                t1 = max(t1, ev.end_ns)
    busy = sum(t.values())
    window = max(t1 - t0, 1.0)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:6]
    return {
        **{f"{k}_s": v * 1e-9 / reps for k, v in t.items()},
        "busy_s": busy * 1e-9 / reps,
        "window_s": window * 1e-9 / reps,
        "idle_share": 1.0 - busy / window,
        "top_ops": [[op, ns * 1e-9 / reps, scope_of.get(op, "other")]
                    for op, ns in top],
    }


def force_layer(sim, state, reps: int = 20) -> dict:
    """The force layer alone: `reps` chained force passes on a fixed
    state in one program. Host-clock seconds per pass, and the traced
    per-pass device time inside the "force" scope."""
    import jax

    @jax.jit
    def force_reps(st):
        def body(xc, _):
            fx, _fy, _fz = sim._force_from(
                st.clusters._replace(xc=xc), st.pairs, st.halo
            )
            return xc + 1e-30 * fx[0, 0], ()

        xc, _ = jax.lax.scan(body, st.clusters.xc, None, length=reps)
        return xc

    compiled = force_reps.lower(state).compile()
    jax.block_until_ready(compiled(state))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(state))
    host = (time.perf_counter() - t0) / reps
    return {"host_s": host, **trace_scopes(compiled, lambda: (state,), reps)}


def run_breakdown(sim, ntimes: int) -> dict:
    """Device time of one traced execution of the whole compiled run,
    per step, split by named scope, with the idle share."""
    run_fn = sim._make_run_fn(ntimes)
    compiled = run_fn.lower(sim.initial_state()).compile()
    import jax

    jax.block_until_ready(compiled(sim.initial_state()))
    return trace_scopes(compiled, lambda: (sim.initial_state(),), ntimes)


def _headline(kernel: str = "auto", repeats: int = 3):
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine_cluster import ClusterSimulation

    params = Params(precision="sp", scheme="cluster", dense_thermo=False,
                    kernel=kernel)
    sim = ClusterSimulation(params)
    out = sim.run(repeats=repeats)
    check_golden(out.temps, params.reneigh_every)
    mups = 1e-6 * sim.natoms * params.ntimes / out.total_time
    return sim, out, mups


def main_ab(device: dict, cards: list[str]) -> int:
    """kernel="ilist_pl" (A) against kernel="ilist" (B), A B B A, each a
    median of 3 timed runs; then the force layer of each from a trace."""
    sims = {}
    rows = []
    for k in ("ilist_pl", "ilist", "ilist", "ilist_pl"):
        sim, out, mups = _headline(k)
        sims[k] = (sim, out)
        rows.append({"kernel": k, "mups": mups,
                     "total_s": out.total_time,
                     "compile_s": out.compile_time})
        print(json.dumps(rows[-1]), flush=True)
    for k, (sim, out) in sims.items():
        print(json.dumps({"kernel": k, "force_layer":
                          force_layer(sim, out.state)}), flush=True)
        print(json.dumps({"kernel": k, "run_per_step":
                          run_breakdown(sim, sim.params.ntimes)}),
              flush=True)
    print(json.dumps({"cards": cards, "device": device}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", action="store_true",
                    help="A/B the cluster kernels ilist_pl and ilist")
    args = ap.parse_args()

    from mdbench_tpu.backend import enable_compile_cache

    enable_compile_cache()
    device = require_gpu()
    cards = card_info()
    if args.ab:
        return main_ab(device, cards)
    sim, out, mups = _headline()
    print(
        json.dumps(
            {
                "metric": "atom_updates_per_second",
                "value": mups * 1e6,
                "unit": "atom-updates/s",
                "kernel": sim._kmode,
                "device": device,
                "card": cards[0],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
