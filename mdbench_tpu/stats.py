"""Workload statistics (reference COMPUTE_STATS, src/verletlist/stats.c).

The reference accumulates per-iteration counters inside the kernels
(addStat). On a device that would poison the hot loop, so the same quantities
are computed analytically from the neighbor lists at reneighbor
boundaries and scaled by the steps each list was live — the totals are
identical because lists are immutable between rebuilds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mdbench_tpu.ops.pallas.lj_cluster import JB

# j-atoms per loop iteration of the GPU exact-list kernel (JB j16
# clusters); the SIMD-iteration analogue of the reference's counters
VECTOR_WIDTH = JB * 16


@dataclass
class Stats:
    total_force_neighs: int = 0
    total_force_iters: int = 0
    atoms_within_cutoff: int = 0
    atoms_outside_cutoff: int = 0
    num_neighs: int = 0  # clusterpair: cluster pairs
    force_iters: int = 0

    def accumulate_list(self, numneigh: np.ndarray, steps_live: int):
        """Add a neighbor list's per-step work, times the steps it was
        used (force runs once per step + once at setup)."""
        nn = int(numneigh.sum())
        iters = int(((numneigh + VECTOR_WIDTH - 1) // VECTOR_WIDTH).sum())
        self.total_force_neighs += nn * steps_live
        self.total_force_iters += iters * steps_live


def compute_cluster_stats(
    clusters,
    pairs,
    n_clusters_pad: int,
    group: int,
    cutforcesq: float,
    cutneighsq: float,
    chunk: int = 16,
    kernel: str = "ilist",  # the engine's resolved kernel
) -> dict:
    """EXACT cluster-scheme counters (reference clusterpair/stats.c:
    26-85): processed cluster pairs, real atom-pair interactions, and
    clusters inside/outside the force cutoff — computed by one masked
    XLA pass over the per-member tile windows (the same pairs the kernel
    touches), chunked over groups to bound memory. Off the hot path:
    called once per report from the final state."""
    import jax
    import jax.numpy as jnp

    if pairs.ijlist is not None:
        return _compute_ilist_stats(
            clusters, pairs, n_clusters_pad, cutforcesq, cutneighsq,
            kernel=kernel,
        )

    ng, _, L = pairs.jlist.shape
    xc, yc, zc = clusters.xc, clusters.yc, clusters.zc
    cjn = xc.shape[0] // 2
    x16 = xc.reshape(cjn, 16)
    y16 = yc.reshape(cjn, 16)
    z16 = zc.reshape(cjn, 16)
    jl_all = pairs.jlist.reshape(ng, L)
    rg_all = pairs.ranges.reshape(ng, 2 * group + 1)
    gm = group * 8

    def chunk_fn(g0):
        gs = g0 + jnp.arange(chunk, dtype=jnp.int32)
        real_g = (gs < ng)[:, None, None]
        gsafe = jnp.where(gs < ng, gs, 0)
        jl = jl_all[gsafe]  # (chunk, L)
        rg = rg_all[gsafe]
        xj = x16[jl].reshape(chunk, 1, L * 16)
        yj = y16[jl].reshape(chunk, 1, L * 16)
        zj = z16[jl].reshape(chunk, 1, L * 16)
        base = gsafe * gm
        rows = base[:, None] + jnp.arange(gm, dtype=jnp.int32)[None, :]
        xi = xc[: n_clusters_pad].reshape(-1)[rows][:, :, None]
        yi = yc[: n_clusters_pad].reshape(-1)[rows][:, :, None]
        zi = zc[: n_clusters_pad].reshape(-1)[rows][:, :, None]
        dxs = xi - xj
        dys = yi - yj
        dzs = zi - zj
        rsq = dxs * dxs + dys * dys + dzs * dzs
        # window mask: lane l -> tile l // 128; row r -> member r // 8
        tile_of_lane = (jnp.arange(L * 16, dtype=jnp.int32) // 128)[None, None, :]
        midx = jnp.arange(gm, dtype=jnp.int32) // 8
        start = jnp.take(rg[:, :group], midx, axis=1)[:, :, None]
        end = jnp.take(rg[:, group : 2 * group], midx, axis=1)[:, :, None]
        inwin = (tile_of_lane >= start) & (tile_of_lane < end) & real_g
        nonself = rsq > 0.0
        in_force = inwin & nonself & (rsq < cutforcesq)
        in_neigh = inwin & nonself & (rsq < cutneighsq)
        pairs_f = jnp.sum(in_force)
        pairs_n = jnp.sum(in_neigh)
        # cluster (ic, j16) granularity: any atom pair within cutforce
        cf = in_force.reshape(chunk, group, 8, L, 16)
        cl_any = jnp.any(jnp.any(cf, axis=4), axis=2)  # (chunk, group, L)
        tile16 = (jnp.arange(L, dtype=jnp.int32) // 8)[None, None, :]
        inwin16 = (
            (tile16 >= rg[:, :group, None])
            & (tile16 < rg[:, group : 2 * group, None])
            & real_g
        )
        cl_in = jnp.sum(cl_any & inwin16)
        cl_proc = jnp.sum(inwin16)
        return pairs_f, pairs_n, cl_in, cl_proc

    ngpad = (ng + chunk - 1) // chunk * chunk
    starts = jnp.arange(0, ngpad, chunk, dtype=jnp.int32)
    pf, pn, ci, cp = jax.lax.map(jax.jit(chunk_fn), starts)
    rg = np.asarray(pairs.ranges)[:, 0, :]
    tiles = int(
        np.maximum(rg[:, group : 2 * group] - rg[:, :group], 0).sum()
    )
    return dict(
        pairs_within_cutforce=int(np.asarray(pf.sum())),
        pairs_within_cutneigh=int(np.asarray(pn.sum())),
        clusters_within_cutoff=int(np.asarray(ci.sum())),
        clusters_processed=int(np.asarray(cp.sum())),
        tiles=tiles,
        padded_pairs=tiles * 1024,
    )


def _compute_ilist_stats(
    clusters, pairs, n_clusters_pad: int,
    cutforcesq: float, cutneighsq: float, chunk: int = 256,
    kernel: str = "ilist",
) -> dict:
    """Exact counters for the exact-list (kernel=ilist*) path: the
    kernel processes every (i-unit row, listed j16) pair tile, so the
    processed/real/within-cutoff counts come from ijlist/nji directly
    (reference clusterpair/stats.c:26-85 semantics at unit
    granularity)."""
    import jax
    import jax.numpy as jnp

    ijl = pairs.ijlist
    nji = np.asarray(pairs.nji)
    nu, icap = ijl.shape
    share = n_clusters_pad // nu
    xc, yc, zc = clusters.xc, clusters.yc, clusters.zc
    cjn = xc.shape[0] // 2
    x16 = xc.reshape(cjn, 16)
    y16 = yc.reshape(cjn, 16)
    z16 = zc.reshape(cjn, 16)
    W = icap * 16
    lane_live = (
        jnp.arange(W, dtype=jnp.int32)[None, :] // 16
        < jnp.asarray(pairs.nji)[:, None]
    )  # (nu, W) — listed (vs padding) lanes

    def chunk_fn(u0):
        us = u0 + jnp.arange(chunk, dtype=jnp.int32)
        usafe = jnp.where(us < nu, us, 0)
        real_u = (us < nu)[:, None, None]
        jl = ijl[usafe]
        xj = x16[jl].reshape(chunk, 1, W)
        yj = y16[jl].reshape(chunk, 1, W)
        zj = z16[jl].reshape(chunk, 1, W)
        rows = usafe[:, None] * (share * 8) + jnp.arange(
            share * 8, dtype=jnp.int32)[None, :]
        xi = xc[:n_clusters_pad].reshape(-1)[rows][:, :, None]
        yi = yc[:n_clusters_pad].reshape(-1)[rows][:, :, None]
        zi = zc[:n_clusters_pad].reshape(-1)[rows][:, :, None]
        dx = xi - xj
        dy = yi - yj
        dz = zi - zj
        rsq = dx * dx + dy * dy + dz * dz
        live = lane_live[usafe][:, None, :] & real_u
        nonself = rsq > 0.0
        in_force = live & nonself & (rsq < cutforcesq)
        in_neigh = live & nonself & (rsq < cutneighsq)
        cf = in_force.reshape(chunk, share * 8, icap, 16)
        cl_any = jnp.any(jnp.any(cf, axis=3), axis=1)  # (chunk, icap)
        return (jnp.sum(in_force), jnp.sum(in_neigh),
                jnp.sum(cl_any))

    nupad = (nu + chunk - 1) // chunk * chunk
    starts = jnp.arange(0, nupad, chunk, dtype=jnp.int32)
    pf, pn, ci = jax.lax.map(jax.jit(chunk_fn), starts)
    cl_proc = int(nji.sum())
    # padded-pair accounting follows what the kernel EXECUTES: the GPU
    # kernel loops over each unit's own list in JB-cluster tiles, the
    # XLA twin evaluates the full icap width of every unit
    if kernel == "ilist_pl":
        padded = int(((nji + JB - 1) // JB).sum()) * JB * 16 * share * 8
    else:
        padded = nu * share * 8 * icap * 16
    tiles = padded // 1024  # 1024-pair tiles, as on the group-list path
    return dict(
        pairs_within_cutforce=int(np.asarray(pf.sum())),
        pairs_within_cutneigh=int(np.asarray(pn.sum())),
        clusters_within_cutoff=int(np.asarray(ci.sum())),
        clusters_processed=cl_proc,
        tiles=tiles,
        padded_pairs=padded,
    )


def display_statistics(
    stats: Stats,
    nlocal: int,
    ntimes: int,
    force_time: float,
    proc_freq: float,
    float_size: int,
) -> str:
    """Render the statistics block (reference stats.c:22-68)."""
    evals = nlocal * (ntimes + 1)
    force_useful_volume = 1e-9 * (
        float(evals) * (float_size * 6 + 4)
        + float(stats.total_force_neighs) * (float_size * 3 + 4)
    )
    avg_neigh = stats.total_force_neighs / float(evals)
    avg_simd = stats.total_force_iters / float(evals)
    lines = ["Statistics:"]
    lines.append(
        "\tVector width: %d, Processor frequency: %.4f GHz"
        % (VECTOR_WIDTH, proc_freq)
    )
    lines.append("\tAverage neighbors per atom: %.4f" % avg_neigh)
    lines.append("\tAverage SIMD iterations per atom: %.4f" % avg_simd)
    lines.append(
        "\tTotal number of computed pair interactions: %d"
        % stats.total_force_neighs
    )
    lines.append(
        "\tTotal number of SIMD iterations: %d" % stats.total_force_iters
    )
    lines.append(
        "\tUseful read data volume for force computation: %.2fGB"
        % force_useful_volume
    )
    if stats.total_force_iters and np.isfinite(force_time):
        lines.append(
            "\tCycles/SIMD iteration: %.4f"
            % (force_time * proc_freq * 1e9 / stats.total_force_iters)
        )
    return "\n".join(lines)
