"""LJ force over cluster-pair lists: the exact-list GPU kernel (Pallas
through Triton) and its plain-XLA twins (reference analogues: the
Simd4xN/Simd2xNN and CUDA kernels, src/clusterpair/force_lj.c:167-1199,
forceCuda.cu:190-262).

- ``lj_cluster_force_ilist_gpu``: one program per i-unit (``share``
  i-clusters = share*8 i-atoms). It loops over that unit's own exact
  j16 list, bounded by the unit's real length, loads the j-coordinates
  by index straight from the coordinate planes (which stay in L2), and
  keeps the per-atom force sums in registers until one store. This is
  the GROMACS nbnxm GPU kernel's shape; the fusion XLA cannot do is
  never writing the gathered (nu, icap, 48) j-tiles to memory.
- ``lj_cluster_force_xla_ilist``: the same exact lists as one fused XLA
  gather + elementwise + reduce. CPU path, reference for the kernel,
  typed (EXPLICIT_TYPES) path.
- ``lj_cluster_force_xla``: group-shared lists (kernel="xla").
- ``lj_cluster_force_xla_half``: Newton half lists.

Self/diagonal exclusion: the reference precomputes interaction-mask
tables (atom.c:463-601). Here the only id-equal pairs are an atom
against itself (same cluster diagonal), which sit at exactly rsq == 0 —
so the rsq > 0 cutoff term IS the exclusion mask and no id bookkeeping
exists at all.

Padding: sentinel clusters carry coordinates ~1e30, so padded lanes fail
the cutoff test naturally (the reference's dummy_cj, pbc.c:305-315); the
rsq > 0 term guards sentinel-vs-sentinel pairs whose coordinates
coincide (0 * inf would emit NaN into padding slots).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# j16 clusters the GPU kernel evaluates per loop iteration: the pair
# tile is (share*8, JB*16), a power of two as Triton requires. JB=2 with
# 2 warps was the fastest of jb in {2, 4, 8} x warps in {1, 2, 4, 8} on
# the 131k headline lists (PERF.md, Findings).
JB = 2
NUM_WARPS = 2


def lj_cluster_force_xla(
    xc, yc, zc, jlist, n_clusters_pad: int, group: int,
    cutforcesq, sigma6, epsilon,
    tc=None, tables=None,  # typed runs: type plane + (T,T) jnp tables
):
    """Pure-XLA cluster force over group-shared lists (the reference
    keeps a scalar kernel for the same purpose, computeForceLJRef,
    force_lj.c:47-165). tables = (epsilon, sigma6, cutforcesq) each
    (T, T) arrays for EXPLICIT_TYPES workloads (reference
    clusterpair/atom.c:78-92)."""
    ng, _, L = jlist.shape
    jl = jlist.reshape(ng, L)
    # gather 16-atom j-cluster planes: (ng, L, 16)
    cjn = xc.shape[0] // 2
    x16 = xc.reshape(cjn, 16)
    y16 = yc.reshape(cjn, 16)
    z16 = zc.reshape(cjn, 16)
    xj = x16[jl].reshape(ng, 1, L * 16)
    yj = y16[jl].reshape(ng, 1, L * 16)
    zj = z16[jl].reshape(ng, 1, L * 16)

    xi = xc[: n_clusters_pad].reshape(ng, group * 8, 1)
    yi = yc[: n_clusters_pad].reshape(ng, group * 8, 1)
    zi = zc[: n_clusters_pad].reshape(ng, group * 8, 1)

    if tables is not None:
        eps_t, sig6_t, cutsq_t = tables
        ti = tc[: n_clusters_pad].reshape(ng, group * 8, 1).astype(jnp.int32)
        tj = (
            tc.reshape(cjn, 16)[jl].reshape(ng, 1, L * 16).astype(jnp.int32)
        )
        epsilon = eps_t[ti, tj]
        sigma6 = sig6_t[ti, tj]
        cutforcesq = cutsq_t[ti, tj]

    dx = xi - xj
    dy = yi - yj
    dz = zi - zj
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0)
    rs = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rs
    sr6 = sr2 * sr2 * sr2 * sigma6
    gf = jnp.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)
    fx = jnp.sum(dx * gf, axis=2).reshape(n_clusters_pad, 8)
    fy = jnp.sum(dy * gf, axis=2).reshape(n_clusters_pad, 8)
    fz = jnp.sum(dz * gf, axis=2).reshape(n_clusters_pad, 8)
    return fx, fy, fz


def gather_ilist_rows(xc, yc, zc, ijlist, tc=None):
    """ONE packed row gather for all coordinate planes of the exact
    lists. Returns (nic, icap, 48|64) with j16 cluster c's 16 atoms at
    [:, :, p*16:(p+1)*16] for plane p."""
    nic, icap = ijlist.shape
    cjn = xc.shape[0] // 2
    planes = [xc.reshape(cjn, 16), yc.reshape(cjn, 16), zc.reshape(cjn, 16)]
    if tc is not None:
        planes.append(tc.reshape(cjn, 16))
    packed = jnp.concatenate(planes, axis=1)
    return packed[ijlist.reshape(-1)].reshape(nic, icap, len(planes) * 16)


def lj_cluster_force_xla_ilist(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (NIC/share, icap) int32 — exact per-i-unit j16 ids
    n_clusters_pad: int,
    cutforcesq, sigma6, epsilon,
    tc=None, tables=None,  # typed runs: type plane + (T,T) jnp tables
    share: int = 1,  # i-clusters per shared list (derive_ilists share)
):
    """Exact-list LJ force, fused XLA form — the CPU path, the typed
    path, and the reference the GPU kernel is checked against.

    Reference anchor: per-cluster lists with the exact
    atomDistanceInRange prune (src/clusterpair/neighbor.c:176-436);
    the kernel itself is the computeForceLJ_4xn contraction
    (force_lj.c:613-936) expressed as one fused XLA elementwise+reduce
    over (NIC/share, share*8, icap*16)."""
    nu, icap = ijlist.shape
    assert nu * share == n_clusters_pad
    rows = gather_ilist_rows(xc, yc, zc, ijlist, tc)
    xj = rows[:, :, 0:16].reshape(nu, 1, icap * 16)
    yj = rows[:, :, 16:32].reshape(nu, 1, icap * 16)
    zj = rows[:, :, 32:48].reshape(nu, 1, icap * 16)
    xi = xc[:n_clusters_pad].reshape(nu, share * 8, 1)
    yi = yc[:n_clusters_pad].reshape(nu, share * 8, 1)
    zi = zc[:n_clusters_pad].reshape(nu, share * 8, 1)

    if tables is not None:
        eps_t, sig6_t, cutsq_t = tables
        ti = tc[:n_clusters_pad].reshape(nu, share * 8, 1).astype(jnp.int32)
        tj = rows[:, :, 48:64].reshape(nu, 1, icap * 16).astype(jnp.int32)
        epsilon = eps_t[ti, tj]
        sigma6 = sig6_t[ti, tj]
        cutforcesq = cutsq_t[ti, tj]

    dx = xi - xj
    dy = yi - yj
    dz = zi - zj
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0)
    rs = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rs
    sr6 = sr2 * sr2 * sr2 * sigma6
    gf = jnp.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)
    fx = jnp.sum(dx * gf, axis=2).reshape(n_clusters_pad, 8)
    fy = jnp.sum(dy * gf, axis=2).reshape(n_clusters_pad, 8)
    fz = jnp.sum(dz * gf, axis=2).reshape(n_clusters_pad, 8)
    return fx, fy, fz


def _kernel_ilist_gpu(
    nji_ref, ijl_ref, x_ref, y_ref, z_ref, fx_ref, fy_ref, fz_ref,
    *, ni: int, icap: int, jb: int, cutforcesq: float, a6: float,
    b6: float,
):
    """One i-unit (ni = share*8 i-atoms) against its own j16 list.

    x/y/z_ref are the flat coordinate planes: i-atom a of unit u sits at
    u*ni + a, atom l of j16 cluster c at c*16 + l. The loop runs
    ceil(nji / jb) times over (ni, jb*16) pair tiles; list slots past
    nji hold the sentinel cluster, whose coordinates fail the cutoff, so
    the tail of the last tile adds exact zeros. The per-pair force
    components accumulate elementwise in registers and are reduced over
    the j axis once, after the loop."""
    u = pl.program_id(0)
    i0 = u * ni
    xi = x_ref[pl.ds(i0, ni)][:, None]
    yi = y_ref[pl.ds(i0, ni)][:, None]
    zi = z_ref[pl.ds(i0, ni)][:, None]
    lane = jnp.arange(16, dtype=jnp.int32)[None, :]
    n = jnp.minimum(nji_ref[u], icap)

    def body(k, acc):
        ids = ijl_ref[u, pl.ds(k * jb, jb)]  # (jb,) j16 cluster ids
        idx = ids[:, None] * 16 + lane  # (jb, 16) flat atom rows
        xj = x_ref[idx].reshape(1, jb * 16)
        yj = y_ref[idx].reshape(1, jb * 16)
        zj = z_ref[idx].reshape(1, jb * 16)
        dx = xi - xj
        dy = yi - yj
        dz = zi - zj
        rsq = dx * dx + dy * dy + dz * dz
        mask = (rsq < cutforcesq) & (rsq > 0.0)
        # rsq == 0 (self, sentinel pairs) gives inf here and inf (not
        # NaN) below; the masked select discards it
        sr2 = 1.0 / rsq
        t = sr2 * sr2 * sr2
        # 48*eps*sr6*(sr6 - 0.5)*sr2 with sr6 = t*sigma6, constants folded
        gf = jnp.where(mask, t * sr2 * (a6 * t - b6), 0.0)
        ax, ay, az = acc
        return ax + dx * gf, ay + dy * gf, az + dz * gf

    zero = jnp.zeros((ni, jb * 16), x_ref.dtype)
    ax, ay, az = jax.lax.fori_loop(
        0, (n + jb - 1) // jb, body, (zero, zero, zero)
    )
    fx_ref[pl.ds(i0, ni)] = jnp.sum(ax, axis=1)
    fy_ref[pl.ds(i0, ni)] = jnp.sum(ay, axis=1)
    fz_ref[pl.ds(i0, ni)] = jnp.sum(az, axis=1)


def lj_cluster_force_ilist_gpu(
    xc, yc, zc,  # (C_total, 8) coordinate planes, sentinel pair last
    ijlist,  # (NIC/share, icap) int32 — exact per-i-unit j16 ids
    nji,  # (NIC/share,) int32 — real list length per unit
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
    interpret: bool = False,
):
    """Exact-list LJ force, GPU kernel (Pallas through Triton). Single
    atom type, full lists. Returns (fxc, fyc, fzc) each
    (n_clusters_pad, 8)."""
    nu, icap = ijlist.shape
    assert nu * share == n_clusters_pad
    assert share in (1, 2), "the i-tile (share*8 atoms) must be 8 or 16"
    assert icap % JB == 0, "icap must be a multiple of JB"
    assert xc.shape[0] % 2 == 0, "row count must pair into j16 clusters"
    ni = share * 8
    dtype = xc.dtype
    kern = functools.partial(
        _kernel_ilist_gpu, ni=ni, icap=icap, jb=JB,
        cutforcesq=float(cutforcesq),
        a6=48.0 * float(epsilon) * float(sigma6) ** 2,
        b6=24.0 * float(epsilon) * float(sigma6),
    )
    flat = jax.ShapeDtypeStruct((n_clusters_pad * 8,), dtype)
    fx, fy, fz = pl.pallas_call(
        kern,
        grid=(nu,),
        out_shape=[flat, flat, flat],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="lj_cluster_ilist_gpu",
    )(nji, ijlist, xc.reshape(-1), yc.reshape(-1), zc.reshape(-1))
    return (
        fx.reshape(n_clusters_pad, 8),
        fy.reshape(n_clusters_pad, 8),
        fz.reshape(n_clusters_pad, 8),
    )


def lj_cluster_force_xla_half(
    xc, yc, zc, jlist, n_clusters_pad: int, group: int,
    cutforcesq, sigma6, epsilon,
    tc=None, tables=None,
):
    """Half-neighbor (Newton) cluster force — param.half_neigh analogue
    of the reference's Simd4xN/2xnn HalfNeigh kernels
    (src/clusterpair/force_lj.c:167-431, 613-936), with the same ghost
    semantics as the verlet half kernel (force_lj.c:176-180): a local
    pair (i, j) is computed once, gated by flat slot-id order; pairs with
    a GHOST j are always computed i-side-only (the reaction force arrives
    through the ghost owner's own list at the reciprocal image). The
    Newton reaction forces are folded back by one row scatter-add into
    the 16-wide j-cluster planes. It exists as the reference's config
    axis; the full-list kernels are the default."""
    ng, _, L = jlist.shape
    gm = group * 8
    jl = jlist.reshape(ng, L)
    cjn = xc.shape[0] // 2
    x16 = xc.reshape(cjn, 16)
    y16 = yc.reshape(cjn, 16)
    z16 = zc.reshape(cjn, 16)
    xj = x16[jl].reshape(ng, 1, L * 16)
    yj = y16[jl].reshape(ng, 1, L * 16)
    zj = z16[jl].reshape(ng, 1, L * 16)

    xi = xc[: n_clusters_pad].reshape(ng, gm, 1)
    yi = yc[: n_clusters_pad].reshape(ng, gm, 1)
    zi = zc[: n_clusters_pad].reshape(ng, gm, 1)

    # flat slot ids in the shared row space: i slot k of group g ->
    # g*gm + k; j slot l of j16 c -> c*16 + l (= row*8 + subslot)
    gid_i = (
        jnp.arange(ng, dtype=jnp.int32)[:, None] * gm
        + jnp.arange(gm, dtype=jnp.int32)[None, :]
    )[:, :, None]
    gid_j = (
        jl[:, :, None] * 16 + jnp.arange(16, dtype=jnp.int32)[None, None, :]
    ).reshape(ng, 1, L * 16)
    local_j = gid_j < n_clusters_pad * 8
    half_mask = (~local_j) | (gid_j > gid_i)

    if tables is not None:
        eps_t, sig6_t, cutsq_t = tables
        ti = tc[: n_clusters_pad].reshape(ng, gm, 1).astype(jnp.int32)
        tj = tc.reshape(cjn, 16)[jl].reshape(ng, 1, L * 16).astype(jnp.int32)
        epsilon = eps_t[ti, tj]
        sigma6 = sig6_t[ti, tj]
        cutforcesq = cutsq_t[ti, tj]

    dx = xi - xj
    dy = yi - yj
    dz = zi - zj
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0) & half_mask
    rs = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rs
    sr6 = sr2 * sr2 * sr2 * sigma6
    gf = jnp.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)

    fx = jnp.sum(dx * gf, axis=1).reshape(ng, 1, L * 16)  # j-side sums
    fy = jnp.sum(dy * gf, axis=1).reshape(ng, 1, L * 16)
    fz = jnp.sum(dz * gf, axis=1).reshape(ng, 1, L * 16)
    fxi = jnp.sum(dx * gf, axis=2).reshape(n_clusters_pad, 8)
    fyi = jnp.sum(dy * gf, axis=2).reshape(n_clusters_pad, 8)
    fzi = jnp.sum(dz * gf, axis=2).reshape(n_clusters_pad, 8)

    # Newton reaction: scatter-add -f_j onto LOCAL j16 rows
    keep = local_j.astype(gf.dtype)
    rows = jl.reshape(-1)

    def fold(fj, plane):
        contrib = (-(fj * keep)).reshape(ng * L, 16)
        f16 = jnp.zeros((cjn, 16), plane.dtype).at[rows].add(
            contrib, mode="drop"
        )
        return f16.reshape(2 * cjn, 8)[:n_clusters_pad]

    fxj = fold(fx, xc)
    fyj = fold(fy, yc)
    fzj = fold(fz, zc)
    return fxi + fxj, fyi + fyj, fzi + fzj
