"""Dense O(N^2) force kernels — the correctness oracle.

The reference validates optimized kernels against a scalar reference
kernel (USE_REFERENCE_VERSION, src/clusterpair/force_lj.c:47-165). Our
analogue is an all-pairs minimum-image kernel: exact for cutoff < box/2,
independent of any neighbor-list machinery, and cheap enough for boxes
up to ~10^4 atoms. Every list-based kernel is unit-tested against
this module (see tests/).
"""

from __future__ import annotations

import jax.numpy as jnp


def _pairwise_min_image(x, prd):
    """delta[i, j] = x[i] - x[j], minimum-image over periodic dims."""
    delta = x[:, None, :] - x[None, :, :]
    prd = jnp.asarray(prd, x.dtype)
    delta = delta - prd * jnp.round(delta / prd)
    return delta


def lj_force_dense(x, prd, cutforce: float, sigma6: float, epsilon: float):
    """All-pairs LJ forces with minimum image.

    Same pair math as the reference kernel (force_lj.c:69-75):
    F = 48 * eps * sr6 * (sr6 - 0.5) * sr2, sr6 = sigma6 / r^6.
    Returns (forces (N,3), potential energy, virial).
    """
    n = x.shape[0]
    delta = _pairwise_min_image(x, prd)
    rsq = jnp.sum(delta * delta, axis=-1)
    eye = jnp.eye(n, dtype=bool)
    mask = (rsq < cutforce * cutforce) & ~eye
    rsq_safe = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rsq_safe
    sr6 = sr2 * sr2 * sr2 * sigma6
    force = 48.0 * sr6 * (sr6 - 0.5) * sr2 * epsilon
    force = jnp.where(mask, force, 0.0)
    f = jnp.sum(delta * force[..., None], axis=1)
    epair = jnp.where(mask, 4.0 * epsilon * sr6 * (sr6 - 1.0), 0.0)
    energy = 0.5 * jnp.sum(epair)
    virial = 0.5 * jnp.sum(rsq * force)
    return f, energy, virial


def lj_force_dense_typed(x, types, prd, tables):
    """All-pairs LJ with per-type-pair tables (reference EXPLICIT_TYPES
    path, force_lj.c:61-67). `tables` is a state.TypeTables."""
    n = x.shape[0]
    t = types[:n]
    delta = _pairwise_min_image(x, prd)
    rsq = jnp.sum(delta * delta, axis=-1)
    pair = t[:, None], t[None, :]
    cutsq = tables.cutforcesq[pair]
    sig6 = tables.sigma6[pair]
    eps = tables.epsilon[pair]
    eye = jnp.eye(n, dtype=bool)
    mask = (rsq < cutsq) & ~eye
    rsq_safe = jnp.where(mask, rsq, 1.0)
    sr2 = 1.0 / rsq_safe
    sr6 = sr2 * sr2 * sr2 * sig6
    force = jnp.where(mask, 48.0 * sr6 * (sr6 - 0.5) * sr2 * eps, 0.0)
    return jnp.sum(delta * force[..., None], axis=1)
