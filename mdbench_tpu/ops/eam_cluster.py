"""EAM force on the cluster scheme's exact ilists — two passes with a
ghost-fp refresh between them.

The reference never finished clusterpair EAM (its force_eam.c:20-37 is
a dead stub); this is a completion of that axis: the same
exact per-i-unit j16 lists the LJ fast path uses (ops/cluster.
derive_ilists), the verlet EAM's two-pass dataflow (ops/eam.
compute_force_eam, reference verletlist/force_eam.c:20-231), and the
gather-free polynomial pair evaluation (models/eam_tables.fit_eam_poly)
— so the only per-pair memory traffic is two packed row gathers per
step (48-wide coords for pass 1, 64-wide [x|y|z|fp] for pass 2).

Pass 1: rho_i = sum_j dens(r_ij);  fp_i = F'(rho_i) via the exact
        per-ATOM frho spline (one cheap row gather per atom).
Ghost:  fp ghost rows refreshed through the cluster halo's border map
        (the scalar-field twin of update_cluster_pbc's coordinate
        refresh — no shift, fp is translation invariant).
Pass 2: fpair = -((fp_i + fp_j) * g1(r) + g2(r)); force components
        accumulate per i-atom exactly like the LJ ilist kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from mdbench_tpu.ops.eam import EamDevice, _grid_index, _horner
from mdbench_tpu.ops.pallas.lj_cluster import gather_ilist_rows


def _fp_ghost_refresh(fp_plane, border_map, n_clusters_pad):
    """Fill ghost rows of the (C_total, 8) fp plane from their owner
    rows (row-granular twin of ops/cluster.update_cluster_pbc)."""
    g0 = n_clusters_pad
    gcap16 = border_map.shape[0]
    row_map = (
        2 * border_map[:, None]
        + jnp.arange(2, dtype=jnp.int32)[None, :]
    ).reshape(-1)
    return fp_plane.at[g0 : g0 + 2 * gcap16].set(fp_plane[row_map])


def eam_cluster_force_xla(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (NIC/share, icap) int32 — exact per-i-unit j16 ids
    border_map,  # (gcap16,) cluster halo owner map (ghost fp refresh)
    n_clusters_pad: int,
    cutforcesq: float,
    eam: EamDevice,
    poly,  # models.eam_tables.EamPoly
    share: int = 1,
    fp_exchange=None,
):
    """Fused-XLA cluster EAM force (the parity/CPU twin of the Pallas
    pair; polynomial pair evaluation only — there is no reference
    cluster-EAM semantics to mirror, and the verlet spline path is the
    DP parity oracle). Returns (fx, fy, fz, fp) — force planes
    (n_clusters_pad, 8) and the post-exchange fp plane (C_total, 8).

    fp_exchange(fp_plane) -> fp_plane overrides the default single-chip
    ghost refresh: the multi-chip cluster domain engine passes a
    closure that also ppermutes x-border fp rows over the device mesh
    (the cross-chip analogue of force_eam.c:117-120)."""
    nu, icap = ijlist.shape
    assert nu * share == n_clusters_pad
    W = icap * 16
    dtype = xc.dtype

    xi = xc[:n_clusters_pad].reshape(nu, share * 8, 1)
    yi = yc[:n_clusters_pad].reshape(nu, share * 8, 1)
    zi = zc[:n_clusters_pad].reshape(nu, share * 8, 1)

    def pair_geometry(rows):
        xj = rows[:, :, 0:16].reshape(nu, 1, W)
        yj = rows[:, :, 16:32].reshape(nu, 1, W)
        zj = rows[:, :, 32:48].reshape(nu, 1, W)
        dx = xi - xj
        dy = yi - yj
        dz = zi - zj
        rsq = dx * dx + dy * dy + dz * dz
        mask = (rsq < cutforcesq) & (rsq > 0.0)
        r = jnp.sqrt(jnp.where(mask, rsq, 1.0))
        t = jnp.clip((r - poly.mid) * poly.iscale, -1.0, 1.0)
        return dx, dy, dz, mask, t

    # ---- pass 1: embedding density + fp --------------------------------
    rows48 = gather_ilist_rows(xc, yc, zc, ijlist)
    _, _, _, mask, t = pair_geometry(rows48)
    dens = jnp.where(mask, _horner(poly.dens, t), 0.0)
    rho = jnp.sum(dens, axis=2).reshape(n_clusters_pad, 8)

    mf, pf = _grid_index(rho, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # (npad, 8, 7) — per-atom rows, cheap and exact
    fp_local = (fs[..., 0] * pf + fs[..., 1]) * pf + fs[..., 2]

    fp_plane = jnp.zeros((xc.shape[0], 8), dtype)
    fp_plane = fp_plane.at[:n_clusters_pad].set(fp_local)
    if fp_exchange is None:
        fp_plane = _fp_ghost_refresh(fp_plane, border_map, n_clusters_pad)
    else:
        fp_plane = fp_exchange(fp_plane)

    # ---- pass 2: pair forces -------------------------------------------
    cjn = xc.shape[0] // 2
    packed64 = jnp.concatenate(
        [xc.reshape(cjn, 16), yc.reshape(cjn, 16), zc.reshape(cjn, 16),
         fp_plane.reshape(cjn, 16)],
        axis=1,
    )
    rows64 = packed64[ijlist.reshape(-1)].reshape(nu, icap, 64)
    dx, dy, dz, mask, t = pair_geometry(rows64)
    fpj = rows64[:, :, 48:64].reshape(nu, 1, W)
    fpi = fp_local.reshape(nu, share * 8, 1)
    fpair = jnp.where(
        mask,
        -((fpi + fpj) * _horner(poly.g1, t) + _horner(poly.g2, t)),
        0.0,
    )
    fx = jnp.sum(dx * fpair, axis=2).reshape(n_clusters_pad, 8)
    fy = jnp.sum(dy * fpair, axis=2).reshape(n_clusters_pad, 8)
    fz = jnp.sum(dz * fpair, axis=2).reshape(n_clusters_pad, 8)
    return fx, fy, fz, fp_plane
