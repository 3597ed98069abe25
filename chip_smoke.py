"""Smoke test of the main path on one GPU, all phases in this process.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --multi   # four cards: the domain engines only

1. device: JAX must report a GPU (never falls back to the CPU); prints
   the card's name and power limit, device kind and count.
2. kernel parity at the 131k headline shapes: the GPU exact-list kernel
   against the fused-XLA twin in f32 (max|df|/max|f| <= 1e-5: the two
   sum in different orders), and both against the twin in f64.
3. cluster scheme, SP, kernel="auto", 200 steps: golden gate, rate,
   compile seconds, peak device memory.
4. verlet scheme, SP, kernel="auto", 200 steps: golden gate, rate.
5. cluster scheme, DP (x64 on for this phase only), 200 steps: golden
   gate against the C reference's DP trace.

--multi: ClusterDomainSimulation and DomainSimulation on a 4-device 1-D
mesh at the headline box, each against its one-card engine
(temperatures over the first 20 steps, rtol 2e-5) and the golden gate
at 200 steps.

Any failure exits non-zero. The last line of stdout is one JSON object
{"ok": true, "device": {...}} and is printed only when every phase
passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

PARITY_TOL = 1e-5
MESH_RTOL = 2e-5


def phase_device():
    import jax

    from bench import card_info, require_gpu

    device = require_gpu()
    cards = card_info()
    for line in cards:
        print(line, flush=True)
    print(f"[device] kind={device['kind']} count={device['count']} "
          f"platform={device['platform']} jax={jax.__version__}",
          flush=True)
    return device, cards


def _perturbed_headline_sim():
    """The 131k headline box, positions jittered from a seed so the
    forces are O(1) (a perfect lattice has only cancellation noise),
    lists calibrated as the engine's run() calibrates them."""
    import jax

    from mdbench_tpu.config import Params
    from mdbench_tpu.engine_cluster import ClusterSimulation
    from mdbench_tpu.models.lattice import create_fcc_lattice

    p = Params(precision="sp", scheme="cluster", kernel="ilist_pl")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(1234).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, adjust=False)
    st = sim.initial_state()
    jax.block_until_ready(st)
    if sim._calibrate_list_cap(st):
        st = sim.initial_state()
    if bool(np.any(np.asarray(st.overflow))):
        raise SystemExit("[parity] capacity overflow on the parity state")
    return sim, st


def phase_parity():
    import jax
    import jax.numpy as jnp

    from mdbench_tpu.ops.pallas.lj_cluster import (
        lj_cluster_force_ilist_gpu,
        lj_cluster_force_xla_ilist,
    )

    sim, st = _perturbed_headline_sim()
    p = sim.params
    cl, pairs = st.clusters, st.pairs
    args = (p.cutforce**2, p.sigma6, p.epsilon)
    npad = sim.n_clusters_pad
    k32 = jax.jit(lambda xc, yc, zc, ijl, nji: lj_cluster_force_ilist_gpu(
        xc, yc, zc, ijl, nji, npad, *args, share=sim.ishare))
    x32 = jax.jit(lambda xc, yc, zc, ijl: lj_cluster_force_xla_ilist(
        xc, yc, zc, ijl, npad, *args, share=sim.ishare))
    fk = np.stack([np.asarray(f) for f in k32(
        cl.xc, cl.yc, cl.zc, pairs.ijlist, pairs.nji)])
    fx = np.stack([np.asarray(f) for f in x32(
        cl.xc, cl.yc, cl.zc, pairs.ijlist)])
    with jax.enable_x64(True):
        planes = [jnp.asarray(np.asarray(a), jnp.float64)
                  for a in (cl.xc, cl.yc, cl.zc)]
        f64 = np.stack([np.asarray(f) for f in jax.jit(
            lambda xc, yc, zc, ijl: lj_cluster_force_xla_ilist(
                xc, yc, zc, ijl, npad, *args, share=sim.ishare)
        )(*planes, pairs.ijlist)])
        fk64 = np.stack([np.asarray(f) for f in jax.jit(
            lambda xc, yc, zc, ijl, nji: lj_cluster_force_ilist_gpu(
                xc, yc, zc, ijl, nji, npad, *args, share=sim.ishare)
        )(*planes, pairs.ijlist, pairs.nji)])
    fmax = float(np.abs(f64).max())
    rel = float(np.abs(fk - fx).max()) / float(np.abs(fx).max())
    rel_k64 = float(np.abs(fk - f64).max()) / fmax
    rel_x64 = float(np.abs(fx - f64).max()) / fmax
    rel_kk64 = float(np.abs(fk64 - f64).max()) / fmax
    nji = np.asarray(pairs.nji)
    print(f"[parity] natoms={sim.natoms} n_clusters_pad={npad} "
          f"icap={pairs.ijlist.shape[1]} share={sim.ishare} "
          f"nji mean={nji.mean():.2f} max={nji.max()} max|f|={fmax:.4e}",
          flush=True)
    print(f"[parity] f32 kernel vs f32 twin: {rel:.3e} (tol {PARITY_TOL})")
    print(f"[parity] vs f64 twin: f32 kernel {rel_k64:.3e}, f32 twin "
          f"{rel_x64:.3e}, f64 kernel {rel_kk64:.3e}", flush=True)
    if not rel <= PARITY_TOL:
        raise SystemExit(f"[parity] FAILED: {rel:.3e} > {PARITY_TOL}")
    if not rel_kk64 <= 1e-12:
        raise SystemExit(f"[parity] FAILED: f64 kernel {rel_kk64:.3e}")


def _report(tag, sim, out, natoms, ntimes, cards, errs):
    from bench import peak_bytes

    mups = 1e-6 * natoms * ntimes / out.total_time
    print(f"[{tag}] kernel={sim._kmode} natoms={natoms} steps={ntimes} "
          f"M atom-updates/s={mups!r} total_s={out.total_time!r} "
          f"compile_s={out.compile_time!r} peak_bytes={peak_bytes()} "
          f"card={cards[0]!r}", flush=True)
    print(f"[{tag}] golden rel err by step: "
          + " ".join(f"{s}:{e:.2e}" for s, e in errs.items()), flush=True)


def phase_cluster(cards):
    from bench import check_golden
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine_cluster import ClusterSimulation

    p = Params(precision="sp", scheme="cluster", dense_thermo=False)
    sim = ClusterSimulation(p)
    out = sim.run()
    errs = check_golden(out.temps, p.reneigh_every)
    _report("cluster-sp", sim, out, sim.natoms, p.ntimes, cards, errs)


def phase_verlet(cards):
    from bench import check_golden
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine import Simulation

    p = Params(precision="sp", scheme="verlet", dense_thermo=False)
    sim = Simulation(p)
    out = sim.run()
    errs = check_golden(out.temps, p.reneigh_every)
    _report("verlet-sp", sim, out, sim.natoms, p.ntimes, cards, errs)


def phase_dp(cards):
    import jax

    from bench import check_golden
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine_cluster import ClusterSimulation

    with jax.enable_x64(True):
        p = Params(precision="dp", scheme="cluster", dense_thermo=False)
        sim = ClusterSimulation(p)
        out = sim.run()
        if np.asarray(out.temps).dtype != np.float64:
            raise SystemExit("[cluster-dp] run did not compute in f64")
    errs = check_golden(out.temps, p.reneigh_every)
    _report("cluster-dp", sim, out, sim.natoms, p.ntimes, cards, errs)


def phase_multi(cards, ndev: int = 4):
    """Domain engines on an ndev-device mesh against the one-card
    engines, same 131k box."""
    import jax

    from bench import check_golden
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.engine_cluster import ClusterSimulation
    from mdbench_tpu.parallel.cluster_domain import ClusterDomainSimulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    if len(jax.devices()) < ndev:
        raise SystemExit(f"[multi] needs {ndev} devices, "
                         f"found {len(jax.devices())}")
    cases = (
        ("cluster", ClusterDomainSimulation, ClusterSimulation),
        ("verlet", DomainSimulation, Simulation),
    )
    for scheme, Domain, Single in cases:
        p = Params(precision="sp", scheme=scheme)
        dom = Domain(p, ndev)
        t0 = time.perf_counter()
        res = dom.run()
        wall = time.perf_counter() - t0
        temps = np.asarray(res.temps)
        nloc = np.asarray(
            res.state.nlocal if scheme == "verlet" else res.nlocal
        ).reshape(-1)
        if not (nloc > 0).all():
            raise SystemExit(f"[multi-{scheme}] a device owns no atoms: "
                             f"{nloc.tolist()}")
        errs = check_golden(temps, p.reneigh_every)
        ref = Single(Params(precision="sp", scheme=scheme, ntimes=20))
        t_ref = np.asarray(ref.run().temps)[:20]
        rel = float(np.max(np.abs(temps[:20] - t_ref) / np.abs(t_ref)))
        mups = 1e-6 * dom.natoms * p.ntimes / res.total_time
        print(f"[multi-{scheme}] devices={ndev} atoms/device="
              f"{nloc.tolist()} first-20-step temp max rel diff vs one "
              f"card={rel:.3e} (rtol {MESH_RTOL}) M atom-updates/s="
              f"{mups!r} run_wall_s={wall!r} card={cards[0]!r}",
              flush=True)
        print(f"[multi-{scheme}] golden rel err by step: "
              + " ".join(f"{s}:{e:.2e}" for s, e in errs.items()),
              flush=True)
        if not rel <= MESH_RTOL:
            raise SystemExit(f"[multi-{scheme}] FAILED: {rel:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device domain-engine phase")
    args = ap.parse_args()

    from mdbench_tpu.backend import enable_compile_cache

    enable_compile_cache()
    device, cards = phase_device()
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(cards)
    else:
        for phase in (phase_parity, lambda: phase_cluster(cards),
                      lambda: phase_verlet(cards), lambda: phase_dp(cards)):
            phase()
    print(f"[done] wall_s={time.perf_counter() - t0!r}", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
