"""Synthetic-workload kernel microbenchmark — the reference's `-stub`
variant (src/verletlist/main-stub.c): fake atoms + synthetic neighbor
lists with controlled access patterns replace the whole data/neighbor
stack, so the force kernel is measured in isolation for cache/pattern
studies.

Patterns (main-stub.c:60-105):
  seq  — neighbors of i are i+1, i+2, ... (mod Nlocal)
  fix  — every atom's neighbors are 0, 1, ..., nneighs-1
  rand — nneighs distinct random neighbors != i
replicated `nreps` times per row; cutforce = 1e6 so every pair interacts
(main-stub.c:46-47).

Metrics (main-stub.c:280-320): Mega atom updates/s, cycles/atom,
cycles/neighbor, optional CSV row.

Usage: python -m mdbench_tpu.stub [-na N] [-nn NN] [-nr R]
       [--pattern seq|fix|rand] [-n steps] [--csv] [-half 0|1]
       [-f lj|eam] [-e funcfl_file]   (EAM: verlet scheme only, like
       the reference — clusterpair EAM is a dead stub there)
"""

from __future__ import annotations

import sys
import time

import numpy as np


def create_stub_atoms(natoms: int):
    """Synthetic positions (reference: main-stub.c places atoms at tiny
    increments so all pairs interact)."""
    i = np.arange(natoms, dtype=np.float64)
    x = np.stack([i * 1e-5, i * 1e-5, i * 1e-5], axis=1)
    v = np.zeros_like(x)
    return x, v


def create_neighbors(natoms: int, pattern: str, nneighs: int, nreps: int,
                     seed: int = 42):
    """Synthetic fixed-width lists (reference createNeighbors,
    main-stub.c:60-105)."""
    maxneighs = nneighs * nreps
    neigh = np.zeros((natoms, maxneighs), np.int32)
    if pattern == "rand" and natoms <= nneighs:
        raise ValueError(
            "random pattern requires natoms > nneighs (main-stub.c:67-71)"
        )
    rng = np.random.default_rng(seed)
    for i in range(natoms):
        if pattern == "seq":
            row = (i + 1 + np.arange(nneighs)) % natoms
        elif pattern == "fix":
            row = np.arange(nneighs) % nneighs
        elif pattern == "rand":
            row = rng.choice(natoms, size=nneighs + 1, replace=False)
            row = row[row != i][:nneighs]
        else:
            raise ValueError(f"unknown pattern {pattern}")
        neigh[i] = np.tile(row, nreps)
    numneigh = np.full(natoms, maxneighs, np.int32)
    return neigh, numneigh


def run_stub(
    natoms: int = 65536,
    nneighs: int = 76,
    nreps: int = 1,
    pattern: str = "seq",
    ntimes: int = 200,
    half: bool = False,
    proc_freq: float = 2.4,
    csv: bool = False,
    precision: str = "sp",
    force_field: str = "lj",
    eam_file: str | None = None,
    eam_eval: str = "spline",
) -> dict:
    import jax
    import jax.numpy as jnp

    from mdbench_tpu.ops.lj import (
        compute_force_lj_full,
        compute_force_lj_half,
    )

    dtype = jnp.float64 if precision == "dp" else jnp.float32
    xh, _ = create_stub_atoms(natoms)
    neigh_h, numneigh_h = create_neighbors(natoms, pattern, nneighs, nreps)

    nlocal_pad = natoms
    x = jnp.asarray(
        np.concatenate([xh, [[1e30, 1e30, 1e30]]]), dtype
    )  # + sentinel row
    neigh = jnp.asarray(neigh_h)
    numneigh = jnp.asarray(numneigh_h)
    cutsq = 1.0e6**2  # all pairs hit (main-stub.c:46)

    if force_field == "eam":
        # reference: main-stub.c:200 calls initEam, which overrides
        # cutforce with the table cutoff (eam_utils.c:22-40); the stub
        # then measures the two-pass EAM kernel over the synthetic
        # lists. No ghosts in the stub -> empty fp border exchange.
        from mdbench_tpu.models.eam_tables import load_eam
        from mdbench_tpu.ops.eam import EamDevice, compute_force_eam

        if not eam_file:
            raise ValueError("-f eam requires -e <funcfl file>")
        t = load_eam(eam_file)
        eam_dev = EamDevice(
            rhor=jnp.asarray(t.rhor_spline, dtype),
            frho=jnp.asarray(t.frho_spline, dtype),
            z2r=jnp.asarray(t.z2r_spline, dtype),
            rdr=t.rdr, rdrho=t.rdrho, nr=t.nr, nrho=t.nrho,
        )
        cutsq = float(t.cut) ** 2
        bmap = jnp.zeros((0,), jnp.int32)

        if eam_eval == "poly":
            # gather-free pair evaluation axis: kernel-isolated
            # spline-vs-poly measurement (--eam-eval poly)
            from mdbench_tpu.models.eam_tables import fit_eam_poly
            from mdbench_tpu.ops.eam import compute_force_eam_poly

            poly = fit_eam_poly(t)

            def force(x):
                f, _fp = compute_force_eam_poly(
                    x, neigh, numneigh, bmap, natoms, nlocal_pad,
                    cutsq, eam_dev, poly,
                )
                return f
        else:
            def force(x):
                f, _fp = compute_force_eam(
                    x, neigh, numneigh, bmap, natoms, nlocal_pad,
                    cutsq, eam_dev,
                )
                return f

    elif half:

        def force(x):
            return compute_force_lj_half(
                x, neigh, numneigh, natoms, nlocal_pad, cutsq, 1.0, 1.0
            )

    else:

        def force(x):
            return compute_force_lj_full(
                x, neigh, numneigh, nlocal_pad, cutsq, 1.0, 1.0
            )

    @jax.jit
    def loop(x):
        def body(x, _):
            f = force(x)
            return x.at[:nlocal_pad].add(1e-30 * f), ()

        x, _ = jax.lax.scan(body, x, None, length=ntimes)
        return x

    jax.block_until_ready(loop(x))  # compile + warm-up
    t0 = time.perf_counter()
    jax.block_until_ready(loop(x))
    total = time.perf_counter() - t0

    freq_hz = proc_freq * 1e9
    upd_per_s = natoms / total * ntimes
    cy_atom = total / natoms / ntimes * freq_hz
    cy_neigh = cy_atom / nneighs
    result = dict(
        force_field=force_field, pattern=pattern, natoms=natoms,
        nneighs=nneighs, nreps=nreps, ntimes=ntimes, total=total,
        mega_updates=upd_per_s / 1e6, cycles_per_atom=cy_atom,
        cycles_per_neighbor=cy_neigh,
    )
    if csv:
        print("steps,pattern,natoms,nneighs,nreps,time(s),atom upds/s(M),"
              "cy/atom,cy/neigh")
        print(
            "%d,%s,%d,%d,%d,%.4f,%.4f,%.4f,%.4f"
            % (ntimes, pattern, natoms, nneighs, nreps, total,
               upd_per_s / 1e6, cy_atom, cy_neigh)
        )
    else:
        print(
            "Total time: %.4f, Mega atom updates/s: %.4f"
            % (total, upd_per_s / 1e6)
        )
        print(
            "Cycles per atom: %.4f, Cycles per neighbor: %.4f"
            % (cy_atom, cy_neigh)
        )
    return result


def create_stub_clusters(n_clusters: int, group: int = 16):
    """Synthetic cluster planes (cluster-scheme stub, reference
    clusterpair/main-stub.c:61-120): 8-atom clusters at tiny coordinate
    increments so every pair interacts; padded to a multiple of
    8*group rows plus the sentinel pair."""
    blk = 8 * group
    n_pad = (n_clusters + blk - 1) // blk * blk
    rows = n_pad + 2  # even total; last pair = all-sentinel
    idx = np.arange(n_pad * 8, dtype=np.float64).reshape(n_pad, 8)
    xc = np.full((rows, 8), 1e30)
    yc = np.full((rows, 8), 1e30)
    zc = np.full((rows, 8), 1e30)
    xc[:n_pad] = idx * 1e-5
    yc[:n_pad] = idx * 1e-5
    zc[:n_pad] = idx * 1e-5
    return xc, yc, zc, n_pad


def create_cluster_pair_list(
    n_pad: int, group: int, nneighs_j16: int, pattern: str, seed: int = 42
):
    """Synthetic per-group shared j16 lists with seq/fix/rand patterns
    (reference cluster stub createNeighbors, main-stub.c:61-120) and
    full per-member tile windows (imask = ALL)."""
    ng = n_pad // group
    n16 = n_pad // 2
    L = (nneighs_j16 + 7) // 8 * 8
    sentinel16 = (n_pad + 2) // 2 - 1
    jl = np.full((ng, 1, L), sentinel16, np.int32)
    rng = np.random.default_rng(seed)
    for g in range(ng):
        if pattern == "seq":
            row = (g * (group // 2) + 1 + np.arange(nneighs_j16)) % n16
        elif pattern == "fix":
            row = np.arange(nneighs_j16) % n16
        elif pattern == "rand":
            row = rng.choice(n16, size=nneighs_j16, replace=False)
        else:
            raise ValueError(f"unknown pattern {pattern}")
        jl[g, 0, :nneighs_j16] = row
    ntiles = L // 8
    ranges = np.zeros((ng, 1, 2 * group + 1), np.int32)
    ranges[:, 0, group : 2 * group] = (nneighs_j16 + 7) // 8
    ranges[:, 0, 2 * group] = (nneighs_j16 + 7) // 8
    nj = np.full(ng, nneighs_j16, np.int32)
    del ntiles
    return jl, ranges, nj


def run_cluster_stub(
    natoms: int = 65536,
    nneighs: int = 76,  # j16 clusters per group list
    nreps: int = 1,
    pattern: str = "seq",
    ntimes: int = 200,
    proc_freq: float = 2.4,
    csv: bool = False,
    precision: str = "sp",
) -> dict:
    """Cluster-scheme kernel microbenchmark (reference
    clusterpair/main-stub.c): synthetic cluster planes + synthetic
    group-shared j16 lists, force kernel only."""
    import jax
    import jax.numpy as jnp

    from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_xla

    group = 16
    dtype = jnp.float64 if precision == "dp" else jnp.float32
    n_clusters = (natoms + 7) // 8
    xch, ych, zch, n_pad = create_stub_clusters(n_clusters, group)
    jlh, _rgh, _nj = create_cluster_pair_list(
        n_pad, group, nneighs * nreps, pattern
    )
    xc = jnp.asarray(xch, dtype)
    yc = jnp.asarray(ych, dtype)
    zc = jnp.asarray(zch, dtype)
    jl = jnp.asarray(jlh)
    cutsq = 1.0e6**2

    def force(xc):
        return lj_cluster_force_xla(
            xc, yc, zc, jl, n_pad, group, cutsq, 1.0, 1.0
        )

    @jax.jit
    def loop(xc):
        def body(xc, _):
            fx, _fy, _fz = force(xc)
            return xc.at[:n_pad].add(1e-30 * fx), ()

        xc, _ = jax.lax.scan(body, xc, None, length=ntimes)
        return xc

    jax.block_until_ready(loop(xc))  # compile + warm-up
    t0 = time.perf_counter()
    jax.block_until_ready(loop(xc))
    total = time.perf_counter() - t0

    freq_hz = proc_freq * 1e9
    upd_per_s = natoms / total * ntimes
    cy_atom = total / natoms / ntimes * freq_hz
    cy_neigh = cy_atom / max(nneighs * nreps, 1)
    result = dict(
        scheme="cluster", pattern=pattern, natoms=natoms,
        nneighs=nneighs, nreps=nreps, ntimes=ntimes, total=total,
        mega_updates=upd_per_s / 1e6, cycles_per_atom=cy_atom,
        cycles_per_neighbor=cy_neigh,
    )
    if csv:
        print("steps,pattern,natoms,nneighs,nreps,time(s),atom upds/s(M),"
              "cy/atom,cy/neigh")
        print(
            "%d,%s,%d,%d,%d,%.4f,%.4f,%.4f,%.4f"
            % (ntimes, pattern, natoms, nneighs, nreps, total,
               upd_per_s / 1e6, cy_atom, cy_neigh)
        )
    else:
        print(
            "Total time: %.4f, Mega atom updates/s: %.4f"
            % (total, upd_per_s / 1e6)
        )
        print(
            "Cycles per atom: %.4f, Cycles per neighbor: %.4f"
            % (cy_atom, cy_neigh)
        )
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    scheme = "verlet"
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt():
            nonlocal i
            i += 1
            return argv[i]

        if a == "--scheme":
            scheme = nxt()
        elif a == "-na":
            kw["natoms"] = int(nxt())
        elif a == "-nn":
            kw["nneighs"] = int(nxt())
        elif a == "-nr":
            kw["nreps"] = int(nxt())
        elif a == "--pattern":
            kw["pattern"] = nxt()
        elif a in ("-n", "--nsteps"):
            kw["ntimes"] = int(nxt())
        elif a == "-half":
            kw["half"] = bool(int(nxt()))
        elif a == "-f":
            kw["force_field"] = nxt()
        elif a == "-e":
            kw["eam_file"] = nxt()
        elif a == "--freq":
            kw["proc_freq"] = float(nxt())
        elif a == "--csv":
            kw["csv"] = True
        elif a == "--precision":
            kw["precision"] = nxt()
        elif a == "--eam-eval":
            kw["eam_eval"] = nxt()
        i += 1
    from mdbench_tpu.backend import enable_compile_cache

    enable_compile_cache()
    if scheme == "cluster":
        kw.pop("half", None)  # half lists: verlet-stub axis only
        # EAM on the cluster scheme is a dead stub in the reference
        # (clusterpair/force_eam.c:20-37) — same here
        kw.pop("force_field", None)
        kw.pop("eam_file", None)
        kw.pop("eam_eval", None)
        run_cluster_stub(**kw)
    else:
        run_stub(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
