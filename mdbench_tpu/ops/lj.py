"""Lennard-Jones force kernels over Verlet neighbor lists (XLA path).

Pair math matches the reference exactly (src/verletlist/force_lj.c:69-75):
  sr2 = 1/rsq; sr6 = sr2^3 * sigma6; F = 48*eps*sr6*(sr6-0.5)*sr2.

Layout note: all intermediates are PLANAR (N, K) arrays per coordinate
— the single row-gather result is immediately split into coordinate
planes and every later op stays (N, K), so no op carries a minor
dimension of 3. The one gather of (R, 3) rows is the only irregular
access; everything else is dense elementwise work.

Full-neighbor (reference force_lj.c:14-105): gather -> compute -> row
reduce; no scatter at all.

Half-neighbor (force_lj.c:107-198): adds the Newton third-law update
f[j] -= f_pair for local j (ghost j skipped, force_lj.c:176). The
reference's benign OpenMP race becomes a deterministic scatter-add
(SURVEY §5.2); both kept, as in the reference (param.half_neigh).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _planar_delta_rsq(x, neighbors, nlocal_pad):
    """One row-gather, then planar (N, K) coordinate deltas and rsq."""
    xj = x[neighbors]  # (N, K, 3) — consumed immediately, planes split
    xi = x[:nlocal_pad]
    dx = xi[:, 0, None] - xj[:, :, 0]
    dy = xi[:, 1, None] - xj[:, :, 1]
    dz = xi[:, 2, None] - xj[:, :, 2]
    rsq = dx * dx + dy * dy + dz * dz
    return dx, dy, dz, rsq


def _pair_force(rsq, mask, sigma6, epsilon):
    rsq_safe = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rsq_safe
    sr6 = sr2 * sr2 * sr2 * sigma6
    force = 48.0 * sr6 * (sr6 - 0.5) * sr2 * epsilon
    return jnp.where(mask, force, 0.0)


def _gather_pair_tables(tables, types, nlocal_pad, neigh):
    ti = types[:nlocal_pad][:, None]
    tj = types[neigh]
    return (
        tables.cutforcesq[ti, tj],
        tables.sigma6[ti, tj],
        tables.epsilon[ti, tj],
    )


def compute_force_lj_full(
    x: jnp.ndarray,
    neighbors: jnp.ndarray,
    numneigh: jnp.ndarray,
    nlocal_pad: int,
    cutforcesq,
    sigma6,
    epsilon,
    types: Optional[jnp.ndarray] = None,
    tables=None,
) -> jnp.ndarray:
    """Full-neighbor LJ forces. Returns (nlocal_pad, 3)."""
    k = neighbors.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = lane < numneigh[:, None]

    dx, dy, dz, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    if tables is not None:
        cutforcesq, sigma6, epsilon = _gather_pair_tables(
            tables, types, nlocal_pad, neighbors
        )
    mask = valid & (rsq < cutforcesq)
    g = _pair_force(rsq, mask, sigma6, epsilon)
    fx = jnp.sum(dx * g, axis=1)
    fy = jnp.sum(dy * g, axis=1)
    fz = jnp.sum(dz * g, axis=1)
    return jnp.stack([fx, fy, fz], axis=1)


def compute_force_lj_half(
    x: jnp.ndarray,
    neighbors: jnp.ndarray,
    numneigh: jnp.ndarray,
    nlocal: int,
    nlocal_pad: int,
    cutforcesq,
    sigma6,
    epsilon,
    types: Optional[jnp.ndarray] = None,
    tables=None,
) -> jnp.ndarray:
    """Half-neighbor LJ with deterministic Newton scatter-add."""
    k = neighbors.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = lane < numneigh[:, None]

    dx, dy, dz, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    if tables is not None:
        cutforcesq, sigma6, epsilon = _gather_pair_tables(
            tables, types, nlocal_pad, neighbors
        )
    mask = valid & (rsq < cutforcesq)
    g = _pair_force(rsq, mask, sigma6, epsilon)

    cx, cy, cz = dx * g, dy * g, dz * g
    f = jnp.stack(
        [jnp.sum(cx, axis=1), jnp.sum(cy, axis=1), jnp.sum(cz, axis=1)],
        axis=1,
    )
    # Newton: f[j] -= contrib, local j only (reference force_lj.c:176-180).
    # Planar scatter per coordinate into 1-D accumulators (a (R,3) column
    # scatter would hit the slow strided-scatter path).
    jj = jnp.where(mask & (neighbors < nlocal), neighbors, nlocal_pad).reshape(-1)
    fcols = []
    for c in (cx, cy, cz):
        acc = jnp.zeros((nlocal_pad + 1,), x.dtype)
        acc = acc.at[jj].add(-c.reshape(-1), mode="drop")
        fcols.append(acc[:nlocal_pad])
    return f + jnp.stack(fcols, axis=1)


def lj_energy_virial(
    x, neighbors, numneigh, nlocal_pad, cutforcesq, sigma6, epsilon
):
    """Potential energy and virial from a full list (for observability;
    the reference prints only T/P but stats need pair counts)."""
    k = neighbors.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = lane < numneigh[:, None]
    _, _, _, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    mask = valid & (rsq < cutforcesq)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rsq_safe
    sr6 = sr2 * sr2 * sr2 * sigma6
    epair = jnp.where(mask, 4.0 * epsilon * sr6 * (sr6 - 1.0), 0.0)
    force = jnp.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)
    return 0.5 * jnp.sum(epair), 0.5 * jnp.sum(rsq * force)
