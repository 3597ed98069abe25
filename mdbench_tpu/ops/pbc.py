"""Ghost-atom (PBC halo) machinery, fully on device.

The reference walks local atoms appending up to 7 periodic images each
(faces/edges/corners) into border_map + PBC shift arrays
(reference: src/verletlist/pbc.c:90-227 setupPbc), then refreshes ghost
coordinates every step (pbc.c:42-55 updatePbc). Device version: the 26
candidate shifts are tested for all atoms at once; valid (atom, shift)
pairs are compacted by a cumsum + scatter into fixed-capacity halo
arrays. The per-step refresh is a single gather + add that fuses into
the step scan.

This same border_map/shift structure generalizes to the multi-chip halo
exchange (parallel/), where the gather crosses chip boundaries via
collectives instead of staying local.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mdbench_tpu.state import Halo

# All 26 nonzero shift combinations, canonical order.
_SHIFTS = np.array(
    [
        (sx, sy, sz)
        for sx in (-1, 0, 1)
        for sy in (-1, 0, 1)
        for sz in (-1, 0, 1)
        if (sx, sy, sz) != (0, 0, 0)
    ],
    dtype=np.int32,
)


def setup_pbc(
    x: jnp.ndarray,
    nlocal: int,
    nlocal_pad: int,
    ghost_capacity: int,
    prd,
    pbc,
    cutneigh: float,
    sort_grid=None,
) -> Halo:
    """Build the halo map (reference setupPbc semantics, pbc.c:90-227).

    A shift s is valid for atom i iff per dimension d:
      s_d = +1 -> x_d <  cutneigh          (image appears at x + prd)
      s_d = -1 -> x_d >= prd_d - cutneigh  (image appears at x - prd)
      s_d =  0 -> always
    and every dimension with s_d != 0 has PBC enabled. Ghost order is
    (atom-major, canonical shift order) — a different enumeration order
    than the reference, which only permutes ghost indices.

    sort_grid (a CellGrid, optional): additionally order ghosts by
    their cell id. Physics-neutral (any ghost order is valid), but it
    makes ghost 16-atom rows spatially compact, which the rowlist
    force path's per-unit row unions depend on — unsorted ghosts give
    each boundary unit one list entry PER ghost neighbor instead of
    per 16 (roughly twice the row-list width at 131k).
    """
    dtype = x.dtype
    xl = x[:nlocal]
    prd_v = jnp.asarray(prd, dtype)
    pbc_np = np.asarray(pbc, np.int32)

    # Two-stage compaction (a flat (nlocal*26)-candidate sort would
    # take 3.4M keys at 131k to extract ~50k ghosts). Stage 1 compacts the ~28% of atoms
    # within cutneigh of any periodic face (one nlocal single-key
    # sort); stage 2 expands ONLY those by the <=7 valid shift-subset
    # patterns (cutneigh < prd/2 means per dimension at most one of
    # {+1,-1} can be valid, so an atom's valid shifts are exactly the
    # non-empty subsets of its boundary dimensions — the same <=7
    # images the reference appends, pbc.c:90-227). Candidate count
    # drops nlocal*26 -> ghost_capacity*7.
    #
    # Stage-1 capacity = ghost_capacity is safe without a new axis:
    # every boundary atom produces >= 1 ghost, so nboundary > bcap
    # implies nghost > ghost_capacity — already the overflow case
    # (asserted below via the exact closed-form nghost count).
    #
    # Tiny boxes (2*cutneigh >= some periodic prd) break the one-sign-
    # per-dim argument; fall back to the flat 26-candidate form there.
    small_box = any(
        pbc_np[d] != 0 and 2.0 * float(cutneigh) >= float(prd[d])
        for d in range(3)
    )
    if small_box:
        return _setup_pbc_flat26(
            x, nlocal, ghost_capacity, prd, pbc, cutneigh, sort_grid
        )

    lo = xl < cutneigh  # (nlocal, 3)
    hi = xl >= (prd_v - cutneigh)
    pbc_b = jnp.asarray(pbc_np != 0)
    bdim = (lo | hi) & pbc_b[None, :]  # (nlocal, 3) boundary dims
    bmask = jnp.any(bdim, axis=1)

    # exact ghost count: per atom, prod over boundary dims of 2 minus
    # the empty subset = prod(1 + bdim) - 1
    nvalid = (
        (1 + bdim[:, 0].astype(jnp.int32))
        * (1 + bdim[:, 1].astype(jnp.int32))
        * (1 + bdim[:, 2].astype(jnp.int32))
        - 1
    )
    nghost = jnp.sum(nvalid).astype(jnp.int32)
    nboundary = jnp.sum(bmask).astype(jnp.int32)
    bcap = min(int(ghost_capacity), int(nlocal))
    overflow = (nghost > ghost_capacity) | (nboundary > bcap)

    big = jnp.int32(2**31 - 1)
    idx = jnp.arange(nlocal, dtype=jnp.int32)
    (batom,) = jax.lax.sort((jnp.where(bmask, idx, big),), num_keys=1)
    batom = batom[:bcap]
    blive = batom < big
    ba = jnp.minimum(batom, nlocal - 1)

    xb = xl[ba]  # (bcap, 3)
    lob = (xb < cutneigh) & pbc_b[None, :]
    hib = (xb >= (prd_v - cutneigh)) & pbc_b[None, :]
    vdim = lob | hib
    sign = jnp.where(lob, 1, -1)  # +prd image iff near the low face

    # static subset patterns restricted to pbc-enabled dims
    subsets = [
        p for p in range(1, 8)
        if all(pbc_np[d] != 0 for d in range(3) if p & (4 >> d))
    ]
    if not subsets:  # no periodic dimension: no ghosts at all
        sentinel_row = x.shape[0] - 1
        return Halo(
            border_map=jnp.full((ghost_capacity,), sentinel_row, jnp.int32),
            shift=jnp.zeros((ghost_capacity, 3), dtype),
            nghost=jnp.int32(0),
            overflow=jnp.asarray(False),
        )
    keys, ties = [], []
    if sort_grid is not None:
        from mdbench_tpu.ops.cells import coord_to_bin
    for p in subsets:
        in_p = np.array([bool(p & (4 >> d)) for d in range(3)])
        ok = blive & jnp.all(vdim[:, in_p], axis=1)
        s = jnp.where(jnp.asarray(in_p)[None, :], sign, 0)  # (bcap, 3)
        flat = (s[:, 0] + 1) * 9 + (s[:, 1] + 1) * 3 + (s[:, 2] + 1)
        cid = flat - (flat > 13)  # canonical _SHIFTS index
        tie = ba * 26 + cid  # atom-major canonical order, unique
        if sort_grid is not None:
            gx = xb + s.astype(dtype) * prd_v[None, :]
            rank = coord_to_bin(sort_grid, gx)
        else:
            rank = tie
        keys.append(jnp.where(ok, rank, big))
        ties.append(jnp.where(ok, tie, big))
    key = jnp.stack(keys, axis=1).reshape(-1)
    tie = jnp.stack(ties, axis=1).reshape(-1)
    if key.shape[0] < ghost_capacity:  # pool smaller than the halo
        pad = ghost_capacity - key.shape[0]
        key = jnp.concatenate([key, jnp.full((pad,), big)])
        tie = jnp.concatenate([tie, jnp.full((pad,), big)])
    # two sort keys (rank, tie): equal-rank candidates order by the
    # atom-major canonical index, so the compaction is deterministic
    # (and bit-identical in order to the old flat 26-candidate form)
    skey, stie = jax.lax.sort((key, tie), num_keys=2, is_stable=False)
    slot_key = skey[:ghost_capacity]
    slot_tie = jnp.minimum(stie[:ghost_capacity], nlocal * 26 - 1)
    live = slot_key < big
    sentinel_row = x.shape[0] - 1
    border_map = jnp.where(live, slot_tie // 26, sentinel_row)
    shift_tab = jnp.asarray(_SHIFTS).astype(dtype) * prd_v  # (26, 3)
    shift = jnp.where(
        live[:, None], shift_tab[slot_tie % 26], jnp.zeros((), dtype)
    )

    return Halo(border_map=border_map, shift=shift, nghost=nghost, overflow=overflow)


def _setup_pbc_flat26(
    x, nlocal, ghost_capacity, prd, pbc, cutneigh, sort_grid=None
):
    """Flat (nlocal, 26)-candidate halo compaction — the small-box
    fallback of setup_pbc (2*cutneigh >= prd allows BOTH images of a
    dimension, which the subset form's one-sign-per-dim enumeration
    cannot express)."""
    dtype = x.dtype
    xl = x[:nlocal]
    prd_v = jnp.asarray(prd, dtype)
    pbc_v = np.asarray(pbc, np.int32)

    lo = xl < cutneigh  # (nlocal, 3)
    hi = xl >= (prd_v - cutneigh)

    shifts = jnp.asarray(_SHIFTS)  # (26, 3)
    pbc_ok = np.all((np.abs(_SHIFTS) == 0) | (pbc_v[None, :] != 0), axis=1)
    pbc_ok = jnp.asarray(pbc_ok)  # (26,)

    pos_ok = jnp.where(shifts[None, :, :] == 1, lo[:, None, :], True)
    neg_ok = jnp.where(shifts[None, :, :] == -1, hi[:, None, :], True)
    valid = jnp.all(pos_ok & neg_ok, axis=2) & pbc_ok[None, :]  # (nlocal, 26)

    flat_valid = valid.reshape(-1)  # (nlocal*26,)
    nghost = jnp.sum(flat_valid).astype(jnp.int32)
    overflow = nghost > ghost_capacity

    # Packed-key sort compaction (in place of cumsum + dynamic-index
    # scatter, as in the cluster halo). Key ranks valid
    # candidates first — by ghost cell id when sort_grid is given
    # (spatially compact ghost rows for the rowlist force path), else
    # by flat candidate index (exactly the old atom-major order).
    # Ties resolve by the index SECOND KEY, so the sort is deterministic.
    n26 = nlocal * 26
    idx = jnp.arange(n26, dtype=jnp.int32)
    if sort_grid is not None:
        from mdbench_tpu.ops.cells import coord_to_bin

        gx = (
            xl[:, None, :] + (shifts.astype(dtype) * prd_v)[None, :, :]
        ).reshape(-1, 3)
        rank = coord_to_bin(sort_grid, gx)
    else:
        rank = idx
    big = jnp.int32(2**31 - 1)
    key = jnp.where(flat_valid, rank, big)
    # two sort keys (rank, idx): equal-rank candidates order by index,
    # which MAKES the claimed determinism true — num_keys=1 with an
    # unstable sort leaves tie order unspecified across XLA versions
    _skey, sidx = jax.lax.sort((key, idx), num_keys=2, is_stable=False)
    slot_key = _skey[:ghost_capacity]
    slot_idx = sidx[:ghost_capacity]
    live = slot_key < big
    sentinel_row = x.shape[0] - 1
    border_map = jnp.where(live, slot_idx // 26, sentinel_row)
    shift_tab = shifts.astype(dtype) * prd_v  # (26, 3)
    shift = jnp.where(
        live[:, None], shift_tab[slot_idx % 26], jnp.zeros((), dtype)
    )

    return Halo(border_map=border_map, shift=shift, nghost=nghost, overflow=overflow)


def update_pbc(x: jnp.ndarray, halo: Halo, nlocal_pad: int) -> jnp.ndarray:
    """Refresh ghost coordinates from their owners
    (reference updatePbc, pbc.c:42-55): one gather + add.
    Padded halo slots point at the sentinel row (shift 0) and stay inert.
    """
    ghost_x = x[halo.border_map] + halo.shift
    gcap = halo.border_map.shape[0]
    return x.at[nlocal_pad : nlocal_pad + gcap].set(ghost_x)


def ghost_types(types: jnp.ndarray, halo: Halo, nlocal_pad: int) -> jnp.ndarray:
    """Propagate atom types to ghost slots (reference ADDGHOST
    type copy, pbc.c:90-97)."""
    gcap = halo.border_map.shape[0]
    return types.at[nlocal_pad : nlocal_pad + gcap].set(types[halo.border_map])
