"""Shared helpers for the domain-decomposition engines (1-D slabs,
2-D pencils, 3-D bricks): the per-device traced-nloc spatial resort,
the rowlist row-layout rounding, and the melted-probe cap
calibration. One definition so the growth factors, alignment
constants, and calibration margins cannot drift between engines."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def resort_by_cell(grid, x, v, nloc, acap):
    """Traced-nloc spatial resort of a device's locals by cell id
    (sortAtom per device): migration appends arrivals at the END of
    the local region, so without a resort the rowlist units decay into
    spatially arbitrary 16-atom groups and their candidate sets blow
    up. One packed-key sort; padding sorts last."""
    xl = x[:acap]
    bs, dims = grid.binsize, grid.dims
    bx = jnp.clip((xl[:, 0] / bs[0]).astype(jnp.int32) + 1, 0, dims[0] - 1)
    by = jnp.clip((xl[:, 1] / bs[1]).astype(jnp.int32) + 1, 0, dims[1] - 1)
    bz = jnp.clip((xl[:, 2] / bs[2]).astype(jnp.int32) + 1, 0, dims[2] - 1)
    flat = (bx * dims[1] + by) * dims[2] + bz
    live = jnp.arange(acap, dtype=jnp.int32) < nloc
    key = jnp.where(live, flat, jnp.int32(2**31 - 1))
    rid = jnp.arange(acap, dtype=jnp.int32)
    _k, perm = jax.lax.sort((key, rid), num_keys=1, is_stable=False)
    return x.at[:acap].set(xl[perm]), v[perm]


def round16(cap: int) -> int:
    """Local, ghost and border blocks round up to whole 16-atom rows on
    the rowlist path so block boundaries never split a row."""
    return (cap + 15) // 16 * 16


def apply_rowlist_caps(eng, nr, st) -> None:
    """Set an engine's rowlist build capacities from OBSERVED melted
    per-device maxima (the one-shot melted-probe calibration, hoisted so
    the 1-D/2-D/3-D engines share one set of margins; single-chip
    original: engine.py melt calibration).

    nr: (ndev, units) observed numrows per 16-atom unit row;
    st: (ndev, 4) build stats from derive_rowlists_from_cells —
        [max post-bbox candidates, max unit columns, max z-span,
         max rows/cell].

    Sets eng.rcap / ccap / ucl / zw / ubr in place."""
    nr = np.asarray(nr)
    st = np.asarray(st)
    eng.rcap = max((int(nr.max() * 1.3) + 7) // 8 * 8, 16)
    eng.ccap = max((int(st[:, 0].max() * 1.3) + 7) // 8 * 8, 24)
    eng.ucl = max(int(st[:, 1].max()) + 1, 2)
    eng.zw = max(int(st[:, 2].max()) + 3, 3)
    eng.ubr = max(int(st[:, 3].max()) + 2, 4)


def calibrated_block_cap(observed_max: int, floor: int) -> int:
    """Ghost/export block capacity from an observed melted maximum:
    1.25x margin, whole 16-atom rows (update_pbc and the border
    ppermutes gather/write the FULL padded block every step — the
    single-chip ghost-cap lesson; overflow grow-retry backstops a
    larger drift)."""
    return max((int(observed_max * 1.25) + 15) // 16 * 16, floor)
