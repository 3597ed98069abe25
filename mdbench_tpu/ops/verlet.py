"""Verlet neighbor-list construction on device.

The reference scans, per local atom, the 3-D bin stencil and appends
in-range atom ids to a fixed-width row, with a grow-and-retry loop on
overflow (reference: src/verletlist/neighbor.c:186-264). Device version:
the stencil gather is batched over chunks of atoms (lax.map keeps the
peak intermediate at chunk x stencil x capacity), candidates are
masked by cutneigh / self / half-list rules, and each row is compacted
by a cumsum + ranked scatter into the padded (nlocal_pad, maxneighs)
list. Overflow raises a flag; the host grows maxneighs and retraces
(the reference's RESIZE loop, neighbor.c:247-262).

Half-list rule (reference: neighbor.c:223-225): skip j < i. Ghost rows
sit above nlocal_pad so they are always retained, matching the
reference where ghosts live above Nlocal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mdbench_tpu.ops.cells import CellGrid, CellList
from mdbench_tpu.state import NeighborList


def build_neighbors(
    grid: CellGrid,
    cl: CellList,
    x: jnp.ndarray,
    types: jnp.ndarray,
    cutneighsq,  # scalar (ntypes==1) or (ntypes, ntypes) table
    nlocal: int,
    nlocal_pad: int,
    maxneighs: int,
    half: bool,
    chunk: int = 2048,
) -> NeighborList:
    nrows = x.shape[0]
    sentinel_row = nrows - 1
    while nlocal_pad % chunk != 0:
        chunk //= 2
    assert chunk >= 1
    stencil = jnp.asarray(grid.stencil)  # (27,)
    # A safe interior bin for padded rows (its results are masked out).
    d = grid.dims
    safe_bin = (1 * d[1] + 1) * d[2] + 1
    typed = cutneighsq.ndim == 2 if hasattr(cutneighsq, "ndim") else False

    # Per-cell packed rows [x | y | z | id(+type)], built by ONE cell-
    # content gather per rebuild: the stencil fetch below then reads
    # CELL rows, not atoms. The naive per-candidate coordinate gather
    # x[cand] issues nlocal_pad*27*capacity single-row gathers (142M
    # rows at 131k); cell rows cost 27 per atom.
    # Atom ids ride the same rows as exact small floats (nrows < 2^24).
    cap = cl.cells.shape[1]
    dtype = x.dtype
    assert dtype != jnp.float32 or x.shape[0] < 2**24, (
        "atom ids ride the packed rows as floats; above 2^24 rows f32 "
        "cannot represent them exactly — use dp or the rowlist kernel"
    )
    cflat = cl.cells.reshape(-1)
    xcell = x[cflat]  # (ncells*cap, 3)
    planes = [xcell[:, k].reshape(-1, cap) for k in range(3)]
    planes.append(cl.cells.astype(dtype))
    if typed:
        planes.append(types[cflat].reshape(-1, cap).astype(dtype))
    pack = jnp.concatenate(planes, axis=1)  # (ncells, (4|5)*cap)

    def chunk_fn(start):
        i_idx = start + jnp.arange(chunk, dtype=jnp.int32)
        is_real = i_idx < nlocal
        i_safe = jnp.where(is_real, i_idx, 0)
        ib = jnp.where(is_real, cl.bin_of[i_safe], safe_bin)
        cand_bins = ib[:, None] + stencil[None, :]  # (chunk, 27)
        rows = pack[cand_bins]  # (chunk, 27, (4|5)*cap)
        C = 27 * cap
        xjc = rows[:, :, 0:cap].reshape(chunk, C)
        yjc = rows[:, :, cap : 2 * cap].reshape(chunk, C)
        zjc = rows[:, :, 2 * cap : 3 * cap].reshape(chunk, C)
        cand = (
            rows[:, :, 3 * cap : 4 * cap].reshape(chunk, C)
            .astype(jnp.int32)
        )
        xi = x[i_safe]
        dxp = xi[:, 0, None] - xjc
        dyp = xi[:, 1, None] - yjc
        dzp = xi[:, 2, None] - zjc
        rsq = dxp * dxp + dyp * dyp + dzp * dzp
        if typed:
            tj = (
                rows[:, :, 4 * cap : 5 * cap].reshape(chunk, C)
                .astype(jnp.int32)
            )
            cut = cutneighsq[types[i_safe][:, None], tj]
        else:
            cut = cutneighsq
        mask = (rsq <= cut) & (cand != i_idx[:, None]) & is_real[:, None]
        mask &= cand != sentinel_row
        if half:
            mask &= cand > i_idx[:, None]

        nn = jnp.sum(mask, axis=1).astype(jnp.int32)
        # Compact by sorting (j if valid else sentinel) ascending: valid
        # entries land in the first nn columns, sorted by j — row order
        # differs from the reference's bin-scan order (physics is order-
        # independent) and the ascending-j rows improve gather locality.
        # A row sort stands in for a (chunk x C) scatter.
        packed = jnp.where(mask, cand, sentinel_row)
        packed = jnp.sort(packed, axis=1)
        neigh = packed[:, :maxneighs]
        return neigh, nn

    starts = jnp.arange(0, nlocal_pad, chunk, dtype=jnp.int32)
    neighs, nns = jax.lax.map(chunk_fn, starts)
    neighbors = neighs.reshape(nlocal_pad, maxneighs)
    numneigh = nns.reshape(nlocal_pad)
    overflow = jnp.any(numneigh > maxneighs) | cl.overflow
    return NeighborList(neighbors=neighbors, numneigh=numneigh, overflow=overflow)


def derive_rowlists(
    nlist: NeighborList,
    nlocal_pad: int,
    nrows: int,  # coordinate row count (multiple of 16; last 16 rows
    # are pure sentinel so the padded row-id has no real atoms)
    rcap: int,  # packed-row list capacity (multiple of 8)
    chunk: int = 512,
):
    """Packed 16-atom-row lists per unit of 16 consecutive atoms,
    derived from the per-atom Verlet lists: unit u's list = the unique
    values of {j // 16} over its atoms' neighbor rows (plus u itself —
    intra-unit pairs). This is the fast verlet force layout (reference
    analogue: the gather-based SIMD kernel
    src/verletlist/force_lj-x86.c:21-112 — the x86 answer to per-atom
    lists is 8-wide gathers; here it is 16-atom packed-row loads, 16x
    fewer gathered rows than per-atom 3-wide gathers).

    The row lists are a SUPERSET of the per-atom lists at row
    granularity, so the force kernel's rsq < cutforce^2 mask computes
    exactly the same pair set as the planar per-atom path. Padding
    entries hold the sentinel row id (nrows/16 - 1, all-sentinel
    coordinates). Returns (rows (nu, rcap) int32, numrows (nu,),
    overflow)."""
    neighbors, numneigh = nlist.neighbors, nlist.numneigh
    K = neighbors.shape[1]
    assert nrows % 16 == 0 and nlocal_pad % 16 == 0 and rcap % 8 == 0
    nu = nlocal_pad // 16
    sent16 = nrows // 16 - 1
    W = 16 * (K + 1)
    lane = jnp.arange(K, dtype=jnp.int32)[None, :]
    own = (jnp.arange(nlocal_pad, dtype=jnp.int32) // 16)[:, None]
    while nu % chunk != 0 and chunk > 1:
        chunk //= 2

    rows_all = jnp.where(
        lane < numneigh[:, None], neighbors // 16, sent16
    )
    rows_all = jnp.concatenate([rows_all, own], axis=1).reshape(nu, W)
    wpos = jnp.arange(W, dtype=jnp.int32)

    def chunk_fn(u0):
        us = u0 + jnp.arange(chunk, dtype=jnp.int32)
        r = rows_all[us]  # (chunk, W)
        s = jnp.sort(r, axis=1)
        # first occurrence of each distinct non-sentinel value
        first = jnp.concatenate(
            [jnp.ones((chunk, 1), bool), s[:, 1:] != s[:, :-1]], axis=1
        ) & (s != sent16)
        cnt = jnp.sum(first, axis=1).astype(jnp.int32)
        # compact uniques to the front (packed-key sort, same scheme as
        # derive_ilists, in place of a cumsum + scatter)
        key = jnp.where(first, wpos, W + wpos)
        sk, sv = jax.lax.sort((key, s), num_keys=1, dimension=1,
                              is_stable=False)
        out = jnp.where(sk[:, :rcap] < W, sv[:, :rcap], sent16)
        return out, cnt

    starts = jnp.arange(0, nu, chunk, dtype=jnp.int32)
    outs, cnts = jax.lax.map(chunk_fn, starts)
    rows = outs.reshape(nu, rcap)
    numrows = cnts.reshape(nu)
    return rows, numrows, jnp.any(numrows > rcap)


def derive_rowlists_from_cells(
    grid: CellGrid,
    cl: CellList,
    x: jnp.ndarray,  # (nrows, 3) — locals, ghosts, sentinel tail
    nlocal: int,
    nlocal_pad: int,
    rcap: int,
    cutneigh: float,
    brcap: int = 8,  # distinct 16-rows per cell (checked)
    ucol: int = 4,  # distinct xy COLUMNS per 16-atom unit (checked)
    zw: int = 4,  # z-run width: one read covers a unit COLUMN's whole
    # z window [zmin-1, zmin+zw-2]; needs per-column zspan <= zw-3
    ccap: int = 128,  # candidate rows per unit before the exact prune
    chunk: int = 512,
):
    """Packed 16-atom-row lists derived DIRECTLY from the cell table —
    the rowlist path's fast rebuild. Replaces per-atom verlet lists +
    union with a unit-granular pipeline (~16x fewer gathered rows and
    sort rows): per cell, the distinct 16-rows
    of its atoms with their bboxes; per 16-atom unit, the xy stencil
    of its DISTINCT COLUMNS, each stencil column fetched as ONE z-run
    covering that unit column's own z window (per-column windows stay
    small even for units that straddle a column boundary in the
    z-fastest sort order; a per-cell 3x3 z-triple fetch would read
    each stencil column up to 3x zspan times);
    a bbox gap test vs the unit bbox; dedup; then the EXACT unit-row
    min-distance check against cutneigh. The kept set is provably identical to
    derive_rowlists' union of exact per-atom lists (a row is kept iff
    some (i in unit, j in row) pair is within cutneigh), so forces are
    identical. Reference analogue: buildNeighbor's stencil+cutoff
    (src/verletlist/neighbor.c:186-264), at 16-atom row granularity.

    Relies on ghosts being cell-sorted (setup_pbc sort_grid) and
    locals bin-sorted at resort so rows per cell stay few (brcap).
    Returns (rows (nu, rcap) int32, numrows, stats, overflow) — stats
    is an int32 (4,) vector of observed maxima [post-bbox candidates,
    distinct unit columns, per-column z-cell span, distinct rows per
    cell] driving the engine's targeted cap calibration (ccap, ucol,
    zw, brcap)."""
    nrows = x.shape[0]
    assert nrows % 16 == 0 and nlocal_pad % 16 == 0 and rcap % 8 == 0
    nu = nlocal_pad // 16
    sent16 = nrows // 16 - 1
    sentinel_row = nrows - 1
    ZW = zw
    _d0, d1, d2 = grid.dims
    dtype = x.dtype

    # 1. distinct 16-rows per cell (cell content is id-ascending, so
    # r16 is non-decreasing: first-occurrence mask + small compaction
    # sort; NOT a scatter)
    cells = cl.cells  # (nbins+1, cap)
    cap = cells.shape[1]
    validc = cells != sentinel_row
    r16 = cells // 16
    firstc = validc & jnp.concatenate(
        [jnp.ones((cells.shape[0], 1), bool), r16[:, 1:] != r16[:, :-1]],
        axis=1,
    )
    cntc = jnp.sum(firstc, axis=1).astype(jnp.int32)
    cpos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    ckey = jnp.where(firstc, cpos, cap + cpos)
    sk, sr = jax.lax.sort((ckey, r16), num_keys=1, dimension=1,
                          is_stable=False)
    bin_rows = jnp.where(sk[:, :brcap] < cap, sr[:, :brcap], sent16)
    bovf = jnp.any(cntc > brcap)

    # per-candidate-row BBOXES ride the runs table (component-major,
    # like the cluster scheme's bb_cells), and a cheap bbox gap test
    # then prunes candidates BEFORE the expensive exact-prune row
    # gather — the candidate cap (and with it the nu*ccap coordinate
    # gather and the exact-check width) roughly halves.
    n16r = nrows // 16
    fbig = jnp.asarray(1e30, dtype)
    xm = x[:, 0].reshape(n16r, 16)
    ym = x[:, 1].reshape(n16r, 16)
    zm = x[:, 2].reshape(n16r, 16)
    validr = jnp.abs(xm) < 1e29  # padding slots sit at SENTINEL_COORD

    def mm(p):
        lo = jnp.min(jnp.where(validr, p, fbig), axis=1)
        hi = jnp.max(jnp.where(validr, p, -fbig), axis=1)
        return lo, hi

    xlo, xhi = mm(xm)
    ylo, yhi = mm(ym)
    zlo, zhi = mm(zm)
    bb8 = jnp.stack(
        [xlo, xhi, ylo, yhi, zlo, zhi, xlo, xlo], axis=1
    )  # (n16r, 8) — one row gather fetches a whole bbox
    g = bb8[bin_rows]  # (nbins+1, brcap, 8)

    # z-run tables for all 7 fields (row id + 6 bbox components),
    # packed COMPONENT-MAJOR into ONE row per run: row b covers cells
    # b..b+ZW-1 (z is the fastest cell-index dim, so a z window is a
    # flat-id run), laid out [id slots | xlo slots | xhi | ...]. One
    # 7*ZW*brcap-wide gather replaces seven same-index gathers.
    # Component-major keeps every per-field extract a CONTIGUOUS
    # slice of the gathered block (the same layout trick as the
    # cluster scheme's bb_cells, ops/cluster.py bin_clusters); an
    # INTERLEAVED [id|bbox]-per-slot row form would need strided
    # slices and a relayout of the whole gathered block.
    nb1 = bin_rows.shape[0]
    RW = ZW * brcap  # one field's slot count per run row

    def zrun(tbl, fill):
        tp = jnp.concatenate(
            [tbl, jnp.full((ZW, brcap), fill, tbl.dtype)], axis=0
        )
        r = jnp.concatenate(
            [tp[i : i + nb1] for i in range(ZW)], axis=1
        )  # (nbins+1, ZW*brcap)
        # one all-sentinel run at the end: padding cell slots point
        # here so they cost a dead read instead of a real cell's runs
        return jnp.concatenate(
            [r, jnp.full((1, ZW * brcap), fill, tbl.dtype)], axis=0
        )

    runs_pack = jnp.concatenate(
        [zrun(bin_rows.astype(dtype), float(sent16))]
        + [zrun(g[:, :, c], fbig) for c in range(6)],
        axis=1,
    )  # (nbins+2, 7*RW)
    empty_cell = nb1

    # 2. per-unit DISTINCT xy COLUMNS, each with ITS OWN z window.
    # A 16-atom unit in bin-sorted (z-fastest) order can straddle a
    # column boundary — its global z range then spans the whole box —
    # but each of its few distinct columns has a tight atom z range.
    # One packed (col, z)-ascending sort yields both: distinct columns
    # at first occurrences (their own z = the column zmin) and the
    # column zmax by a log-step backward propagation.
    bs = jnp.asarray(grid.binsize, dtype)
    b3 = jnp.floor(x[:nlocal_pad] / bs).astype(jnp.int32) + 1
    b3 = jnp.clip(b3, 0, jnp.asarray(grid.dims, jnp.int32) - 1)
    validu = (jnp.arange(nlocal_pad) < nlocal).reshape(nu, 16)
    big = jnp.int32(1 << 29)
    flat16 = jnp.where(
        validu,
        ((b3[:, 0] * d1 + b3[:, 1]) * d2 + b3[:, 2]).reshape(nu, 16),
        big,
    )
    fs = jnp.sort(flat16, axis=1)  # (col, z) packed ascending
    colS = jnp.where(fs < big, fs // d2, big)
    zS = jnp.where(fs < big, fs % d2, 0)
    # per-slot column zmax: propagate the run's last z backward
    zmax_run = zS
    for k in (1, 2, 4, 8):
        colSh = jnp.concatenate(
            [colS[:, k:], jnp.full((nu, k), big, jnp.int32)], axis=1
        )
        zmh = jnp.concatenate(
            [zmax_run[:, k:], jnp.zeros((nu, k), jnp.int32)], axis=1
        )
        zmax_run = jnp.where(
            colSh == colS, jnp.maximum(zmax_run, zmh), zmax_run
        )
    firstu = jnp.concatenate(
        [jnp.ones((nu, 1), bool), colS[:, 1:] != colS[:, :-1]], axis=1
    ) & (colS < big)
    n_dc = jnp.sum(firstu, axis=1).astype(jnp.int32)
    sovf = jnp.any(n_dc > ucol)
    czspan = jnp.where(firstu, zmax_run - zS, 0)
    zovf = jnp.any(czspan + 3 > ZW)
    p16 = jnp.arange(16, dtype=jnp.int32)[None, :]
    ku = jnp.where(firstu, p16, 16 + p16)
    k2u, colC, zloC = jax.lax.sort(
        (ku, colS, zS), num_keys=1, dimension=1, is_stable=False
    )
    live = k2u[:, :ucol] < 16
    dcol = jnp.where(live, colC[:, :ucol], big)  # (nu, ucol)
    dzlo = jnp.where(live, zloC[:, :ucol], 0)

    # stencil columns: each distinct column x 9 xy offsets, carrying
    # the CONTRIBUTOR column's z window. Duplicate stencil columns
    # (adjacent unit columns sharing a neighbor) are NOT deduped here
    # — merging their windows would re-blow a straddling unit's span,
    # and the row-level dedup below removes the duplicates anyway.
    coloff = jnp.asarray(
        [dx * d1 + dy for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
        jnp.int32,
    )
    zroot = jnp.maximum(dzlo - 1, 0)  # (nu, ucol)
    dcells = jnp.where(
        dcol[:, :, None] < big,
        (dcol[:, :, None] + coloff[None, None, :]) * d2
        + zroot[:, :, None],
        empty_cell,
    ).reshape(nu, ucol * 9)  # (nu, ucol*9) run-start flat cell ids

    # unit bboxes for the bbox gap test (masked over real atoms)
    xi16 = x[:nlocal_pad, 0].reshape(nu, 16)
    yi16 = x[:nlocal_pad, 1].reshape(nu, 16)
    zi16 = x[:nlocal_pad, 2].reshape(nu, 16)

    def umm(p):
        lo = jnp.min(jnp.where(validu, p, fbig), axis=1)
        hi = jnp.max(jnp.where(validu, p, -fbig), axis=1)
        return lo, hi

    uxlo, uxhi = umm(xi16)
    uylo, uyhi = umm(yi16)
    uzlo, uzhi = umm(zi16)

    Wc = ucol * 9 * ZW * brcap
    cutsq = cutneigh * cutneigh

    while nu % chunk != 0 and chunk > 1:
        chunk //= 2
    wpos = jnp.arange(Wc, dtype=jnp.int32)

    def chunk_fn(u0):
        us = u0 + jnp.arange(chunk, dtype=jnp.int32)
        base = jnp.clip(dcells[us], 0, empty_cell)  # (chunk, ucol*9)
        # a run rooted near the top of a column may bleed into the
        # next column's low-z cells: correctness-safe (the exact prune
        # is the authority; dedup removes duplicates), just a few dead
        # candidate lanes

        gall = runs_pack[base]  # (chunk, ucol*9, 7*RW) — ONE gather

        def fld(f):  # contiguous lane slice of the packed gather
            return gall[:, :, f * RW : (f + 1) * RW].reshape(chunk, Wc)

        ids = fld(0).astype(jnp.int32)

        # bbox gap test vs the unit bbox (same prune the cluster
        # scheme's pair search runs, build_cluster_pairs): drops
        # ~half the raw candidates before the dedup/exact stages
        def gap(lo_i, hi_i, lo_j, hi_j):
            return jnp.maximum(
                0.0,
                jnp.maximum(lo_i[us][:, None] - hi_j, lo_j - hi_i[us][:, None]),
            )

        dxg = gap(uxlo, uxhi, fld(1), fld(2))
        dyg = gap(uylo, uyhi, fld(3), fld(4))
        dzg = gap(uzlo, uzhi, fld(5), fld(6))
        dsq = dxg * dxg + dyg * dyg + dzg * dzg
        cand = jnp.where(dsq <= cutsq, ids, sent16)

        # 4. dedup: ascending sort puts copies adjacent and sentinel
        # last; compact first occurrences via packed-key sort
        s = jnp.sort(cand, axis=1)
        first = jnp.concatenate(
            [jnp.ones((chunk, 1), bool), s[:, 1:] != s[:, :-1]], axis=1
        ) & (s != sent16)
        nc = jnp.sum(first, axis=1).astype(jnp.int32)
        key = jnp.where(first, wpos, Wc + wpos)
        k2, v2 = jax.lax.sort((key, s), num_keys=1, dimension=1,
                              is_stable=False)
        cc = min(ccap, Wc)
        cand_c = jnp.where(k2[:, :cc] < Wc, v2[:, :cc], sent16)
        return cand_c, nc

    starts = jnp.arange(0, nu, chunk, dtype=jnp.int32)
    cands, ncs = jax.lax.map(chunk_fn, starts)
    cand = cands.reshape(nu, -1)
    covf = jnp.any(ncs.reshape(-1) > cand.shape[1])

    # 5. exact prune + compaction (same pattern as cluster
    # derive_ilists): one packed 48-wide row gather, min over unit
    # atoms and row minor dim against cutneigh^2
    packed48 = jnp.concatenate([xm, ym, zm], axis=1)  # (n16r, 48)
    cc = cand.shape[1]
    lpos = jnp.arange(cc, dtype=jnp.int32)
    xi_all, yi_all, zi_all = xi16, yi16, zi16

    def prune_fn(u0):
        us = u0 + jnp.arange(chunk, dtype=jnp.int32)
        cu = cand[us]  # (chunk, cc)
        rows = packed48[cu]  # (chunk, cc, 48)
        pl3 = jnp.transpose(
            rows.reshape(chunk, cc, 3, 16), (0, 2, 1, 3)
        ).reshape(chunk, 3, 1, cc * 16)
        xi = xi_all[us][:, :, None]
        yi = yi_all[us][:, :, None]
        zi = zi_all[us][:, :, None]
        dx = xi - pl3[:, 0]
        dy = yi - pl3[:, 1]
        dz = zi - pl3[:, 2]
        rsq = dx * dx + dy * dy + dz * dz  # (chunk, 16, cc*16)
        # mask padding i-atoms: a padding atom and a padding slot of a
        # partial candidate row both sit at SENTINEL_COORD, so the raw
        # rsq=0 would keep junk rows (the derive-aliasing trap flagged
        # in the cluster derive too)
        rsq = jnp.where(validu[us][:, :, None], rsq, fbig)
        mina = jnp.min(rsq, axis=1)
        mind = jnp.min(mina.reshape(chunk, cc, 16), axis=2)
        keep = (mind <= cutsq) & (cu != sent16)
        nr = jnp.sum(keep, axis=1).astype(jnp.int32)
        key = jnp.where(keep, lpos, cc + lpos)
        k2, v2 = jax.lax.sort((key, cu), num_keys=1, dimension=1,
                              is_stable=False)
        rc = min(rcap, cc)
        out = jnp.where(k2[:, :rc] < cc, v2[:, :rc], sent16)
        if rc < rcap:
            out = jnp.concatenate(
                [out, jnp.full((chunk, rcap - rc), sent16, jnp.int32)],
                axis=1,
            )
        return out, nr

    outs, nrs = jax.lax.map(prune_fn, starts)
    rows_out = outs.reshape(nu, rcap)
    numrows = nrs.reshape(nu)
    overflow = (
        bovf | sovf | zovf | covf | jnp.any(numrows > rcap)
    )
    stats = jnp.stack([
        jnp.max(ncs).astype(jnp.int32), jnp.max(n_dc),
        jnp.max(czspan).astype(jnp.int32), jnp.max(cntc),
    ])
    return rows_out, numrows, stats, overflow


def derive_rowlists_from_ranges(
    grid: CellGrid,
    x: jnp.ndarray,  # (nrows, 3) — locals, ghosts, sentinel tail
    nlocal: int,
    nlocal_pad: int,
    gcap: int,  # ghost block length (rows [nlocal_pad, nlocal_pad+gcap))
    rcap: int,
    cutneigh: float,
    ucol: int = 4,  # distinct xy COLUMNS per 16-atom unit (checked)
    kcap: int = 40,  # candidate row-RANGES per unit (checked)
    ccap: int = 128,  # candidate rows per unit before the exact prune
    chunk: int = 512,
):
    """Packed 16-atom-row lists via CONTIGUOUS ROW RANGES — the
    sort-free rebuild. Exploits the engine's sortedness invariants:
    locals are bin-sorted (resort rides every reneighbor on the rowlist
    path) and ghosts are cell-sorted (setup_pbc sort_grid), with z the
    fastest cell-index dimension. Then every stencil column's
    candidates for a unit form ONE contiguous range of 16-row ids
    ([starts[cell(c, z0)], starts[cell(c, z1)+1]) in atom space), so
    the whole candidate-assembly pipeline of derive_rowlists_from_cells
    (cell table + packed z-run bbox fetch + gap test + two Wc-wide
    dedup sorts) collapses into: two searchsorted start tables, one narrow row
    gather of per-column start rows, an ANALYTIC unit-bbox-vs-column
    xy gap prune (no bbox tables at all), a kcap-wide range sort +
    interval-union trim (duplicates only arise as overlapping ranges),
    and a K-way select materialization. The exact min-distance prune
    (stage 5) is unchanged, so the kept set is IDENTICAL to
    derive_rowlists_from_cells' (both keep a row iff some (unit atom,
    row atom) pair is within cutneigh; both emit ascending row ids).
    Reference analogue: buildNeighbor's stencil+cutoff scan
    (src/verletlist/neighbor.c:186-264), at row-range granularity.

    Returns (rows (nu, rcap) int32, numrows, stats, overflow); stats =
    int32 (4,) observed maxima [candidate rows, distinct unit columns,
    non-empty ranges, 0] driving ccap/ucol/kcap calibration."""
    from mdbench_tpu.ops.cells import coord_to_bin

    nrows = x.shape[0]
    assert nrows % 16 == 0 and nlocal_pad % 16 == 0 and rcap % 8 == 0
    nu = nlocal_pad // 16
    sent16 = nrows // 16 - 1
    d0, d1, d2 = grid.dims
    ncols = d0 * d1
    nbins = grid.nbins
    dtype = x.dtype
    cutsq = cutneigh * cutneigh
    fbig = jnp.asarray(1e30, dtype)
    big = jnp.int32(1 << 29)

    # ---- per-cell atom-range start tables (locals + ghosts) --------------
    # starts[b] = first atom index whose bin id >= b; empty cells
    # collapse to zero-length ranges automatically. Valid because the
    # resort key and coord_to_bin are the same function of x.
    ids_l = coord_to_bin(grid, x[:nlocal])
    ids_g = coord_to_bin(grid, x[nlocal_pad : nlocal_pad + gcap])
    q = jnp.arange(nbins + 1, dtype=jnp.int32)
    starts_l = jnp.searchsorted(ids_l, q).astype(jnp.int32)
    starts_g = jnp.searchsorted(ids_g, q).astype(jnp.int32)
    # per-column start rows [SL | SG], one row gather serves both
    # blocks and every z of the column (z is the fastest index, so a
    # column's starts are starts[c*d2 : c*d2+d2]; lane d2 = the next
    # column's first start = this column's end)
    cidx = (jnp.arange(ncols, dtype=jnp.int32)[:, None] * d2
            + jnp.arange(d2 + 1, dtype=jnp.int32)[None, :])
    tab = jnp.concatenate(
        [starts_l[cidx], starts_g[cidx]], axis=1
    )  # (ncols, 2*(d2+1))
    # one all-empty row for dead stencil slots
    tab = jnp.concatenate(
        [tab, jnp.zeros((1, 2 * (d2 + 1)), jnp.int32)], axis=0
    )

    # ---- per-unit distinct columns with their z-cell ranges --------------
    bs = jnp.asarray(grid.binsize, dtype)
    b3 = jnp.floor(x[:nlocal_pad] / bs).astype(jnp.int32) + 1
    b3 = jnp.clip(b3, 0, jnp.asarray(grid.dims, jnp.int32) - 1)
    validu = (jnp.arange(nlocal_pad) < nlocal).reshape(nu, 16)
    flat16 = jnp.where(
        validu,
        ((b3[:, 0] * d1 + b3[:, 1]) * d2 + b3[:, 2]).reshape(nu, 16),
        big,
    )
    fs = jnp.sort(flat16, axis=1)  # (col, z) packed ascending
    colS = jnp.where(fs < big, fs // d2, big)
    zS = jnp.where(fs < big, fs % d2, 0)
    zmax_run = zS  # propagate each column run's last z backward
    for k in (1, 2, 4, 8):
        colSh = jnp.concatenate(
            [colS[:, k:], jnp.full((nu, k), big, jnp.int32)], axis=1
        )
        zmh = jnp.concatenate(
            [zmax_run[:, k:], jnp.zeros((nu, k), jnp.int32)], axis=1
        )
        zmax_run = jnp.where(
            colSh == colS, jnp.maximum(zmax_run, zmh), zmax_run
        )
    firstu = jnp.concatenate(
        [jnp.ones((nu, 1), bool), colS[:, 1:] != colS[:, :-1]], axis=1
    ) & (colS < big)
    n_dc = jnp.sum(firstu, axis=1).astype(jnp.int32)
    sovf = jnp.any(n_dc > ucol)
    p16 = jnp.arange(16, dtype=jnp.int32)[None, :]
    ku = jnp.where(firstu, p16, 16 + p16)
    k2u, colC, zloC, zhiC = jax.lax.sort(
        (ku, colS, zS, zmax_run), num_keys=1, dimension=1,
        is_stable=False,
    )
    live = k2u[:, :ucol] < 16
    dcol = jnp.where(live, colC[:, :ucol], big)  # (nu, ucol)
    dzlo = jnp.where(live, zloC[:, :ucol], 0)
    dzhi = jnp.where(live, zhiC[:, :ucol], 0)

    # unit bboxes (xy only needed — the z window is exact by cells)
    xi16 = x[:nlocal_pad, 0].reshape(nu, 16)
    yi16 = x[:nlocal_pad, 1].reshape(nu, 16)
    zi16 = x[:nlocal_pad, 2].reshape(nu, 16)

    def umm(p):
        lo = jnp.min(jnp.where(validu, p, fbig), axis=1)
        hi = jnp.max(jnp.where(validu, p, -fbig), axis=1)
        return lo, hi

    uxlo, uxhi = umm(xi16)
    uylo, uyhi = umm(yi16)

    coloff = jnp.asarray(
        [dx * d1 + dy for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
        jnp.int32,
    )
    K9 = ucol * 9
    base16g = nlocal_pad // 16
    while nu % chunk != 0 and chunk > 1:
        chunk //= 2
    # assembly chunk: the range stages are many SMALL vector ops whose
    # per-op overhead dominates at 512-unit chunks; their
    # intermediates are (chunk, K) / (chunk, ccap)-sized, so one big
    # chunk is safe — unlike the exact prune, whose (chunk, 16,
    # ccap*16) distance block must stay small.
    chunk_a = nu
    while nu % chunk_a != 0 and chunk_a > 1:
        chunk_a //= 2
    chunk_a = min(chunk_a, 8192)
    lane_z = jnp.arange(d2 + 1, dtype=jnp.int32)
    lpos = jnp.arange(ccap, dtype=jnp.int32)
    RBIG = jnp.int32(1 << 28)  # empty-range sentinel (sorts last)
    packed48 = jnp.concatenate(
        [x[:, 0].reshape(-1, 16), x[:, 1].reshape(-1, 16),
         x[:, 2].reshape(-1, 16)],
        axis=1,
    )

    def chunk_fn(u0):
        us = u0 + jnp.arange(chunk_a, dtype=jnp.int32)
        dc = dcol[us]  # (chunk_a, ucol)
        zl = dzlo[us]
        zh = dzhi[us]
        cs = jnp.where(
            dc[:, :, None] < big, dc[:, :, None] + coloff[None, None, :],
            ncols,
        )  # (chunk_a, ucol, 9) flat stencil column ids (ncols = dead row)
        cs = jnp.clip(cs, 0, ncols)
        # analytic xy gap: unit bbox vs the stencil column's rectangle
        # (bin b covers [(b-1)*bs, b*bs) after the +1 margin shift)
        bxc = (cs // d1).astype(dtype)
        byc = (cs % d1).astype(dtype)
        rxlo = (bxc - 1.0) * bs[0]
        rxhi = bxc * bs[0]
        rylo = (byc - 1.0) * bs[1]
        ryhi = byc * bs[1]
        gx = jnp.maximum(
            0.0,
            jnp.maximum(rxlo - uxhi[us][:, None, None],
                        uxlo[us][:, None, None] - rxhi),
        )
        gy = jnp.maximum(
            0.0,
            jnp.maximum(rylo - uyhi[us][:, None, None],
                        uylo[us][:, None, None] - ryhi),
        )
        keepc = (gx * gx + gy * gy <= cutsq) & (cs < ncols)

        rows_t = tab[cs.reshape(chunk_a, K9)].reshape(
            chunk_a, ucol, 9, 2 * (d2 + 1)
        )  # ONE row gather per stencil slot
        z0 = jnp.maximum(zl - 1, 0)[:, :, None]  # (chunk_a, ucol, 1)
        z1 = jnp.minimum(zh + 1, d2 - 1)[:, :, None]
        sel0 = (lane_z[None, None, None, :] == z0[..., None])
        sel1 = (lane_z[None, None, None, :] == (z1 + 1)[..., None])

        def pick(block, sel):
            return jnp.sum(
                jnp.where(sel, block, 0), axis=3
            )  # (chunk_a, ucol, 9)

        sl_blk = rows_t[:, :, :, : d2 + 1]
        sg_blk = rows_t[:, :, :, d2 + 1 :]
        a0 = pick(sl_blk, sel0)
        a1 = pick(sl_blk, sel1)
        g0 = pick(sg_blk, sel0)
        g1 = pick(sg_blk, sel1)

        def to_rows(lo_a, hi_a, base):
            empty = hi_a <= lo_a
            rlo = base + (lo_a >> 4)
            rhi = base + ((hi_a - 1) >> 4) + 1
            rlo = jnp.where(keepc & ~empty, rlo, RBIG)
            rhi = jnp.where(keepc & ~empty, rhi, RBIG)
            return rlo, rhi

        llo, lhi = to_rows(a0, a1, 0)
        glo, ghi = to_rows(g0, g1, base16g)
        rlo = jnp.concatenate(
            [llo.reshape(chunk_a, K9), glo.reshape(chunk_a, K9)], axis=1
        )
        rhi = jnp.concatenate(
            [lhi.reshape(chunk_a, K9), ghi.reshape(chunk_a, K9)], axis=1
        )
        # sort ranges by lo; non-empty count; truncate to kcap
        rlo_s, rhi_s = jax.lax.sort(
            (rlo, rhi), num_keys=1, dimension=1, is_stable=False
        )
        nk = jnp.sum(rlo_s < RBIG, axis=1).astype(jnp.int32)
        rlo_s = rlo_s[:, :kcap]
        rhi_s = rhi_s[:, :kcap]
        # interval-union trim: overlapping ranges (the only duplicate
        # source) are clipped so the kept intervals are disjoint
        cm = jax.lax.cummax(
            jnp.where(rlo_s < RBIG, rhi_s, 0), axis=1
        )
        pm = jnp.concatenate(
            [jnp.zeros((chunk_a, 1), jnp.int32), cm[:, :-1]], axis=1
        )
        lo2 = jnp.maximum(rlo_s, jnp.minimum(pm, rhi_s))
        ln = jnp.where(
            rlo_s < RBIG, jnp.maximum(rhi_s - lo2, 0), 0
        )
        cum = jnp.cumsum(ln, axis=1) - ln  # exclusive
        total = cum[:, -1] + ln[:, -1]
        # materialize cand(t) = t + off(t), where off is the piecewise-
        # constant offset lo2_k - cum_k of the range covering slot t.
        # Delta form: scatter each NON-EMPTY range's offset JUMP onto
        # its start slot via one (K, ccap) equality select, then a
        # cumsum — ~3 ops per (K, ccap) element vs ~5 for the direct
        # two-compare window select (the big op of the assembly).
        # Empty ranges share their cum with the next range; their delta
        # is forced to 0 and the last-valid-offset prefix fill makes
        # the non-empty jumps chain across them.
        off = lo2 - cum
        valid_k = ln > 0
        offf = jnp.where(valid_k, off, 0)
        seen = valid_k
        sh = 1
        Kw = off.shape[1]
        while sh < Kw:
            offp = jnp.concatenate(
                [jnp.zeros((chunk_a, sh), off.dtype), offf[:, :-sh]],
                axis=1,
            )
            seenp = jnp.concatenate(
                [jnp.zeros((chunk_a, sh), bool), seen[:, :-sh]], axis=1
            )
            offf = jnp.where(seen, offf, offp)
            seen = seen | seenp
            sh *= 2
        prev = jnp.concatenate(
            [jnp.zeros((chunk_a, 1), off.dtype), offf[:, :-1]], axis=1
        )
        delta = jnp.where(valid_k, off - prev, 0)
        dmat = jnp.sum(
            jnp.where(
                lpos[None, None, :] == cum[:, :, None],
                delta[:, :, None], 0,
            ),
            axis=1,
        )  # (chunk_a, ccap)
        cand = lpos[None, :] + jnp.cumsum(dmat, axis=1)
        cand = jnp.where(lpos[None, :] < total[:, None], cand, sent16)
        return cand, total, nk

    starts_a = jnp.arange(0, nu, chunk_a, dtype=jnp.int32)
    starts_u = jnp.arange(0, nu, chunk, dtype=jnp.int32)
    cands, totals, nks = jax.lax.map(chunk_fn, starts_a)
    cand = cands.reshape(nu, ccap)
    total = totals.reshape(nu)
    nk = nks.reshape(nu)
    covf = jnp.any(total > ccap)
    kovf = jnp.any(nk > kcap)

    # ---- exact prune + compaction (same as derive_rowlists_from_cells) --
    def prune_fn(u0):
        us = u0 + jnp.arange(chunk, dtype=jnp.int32)
        cu = cand[us]  # (chunk, ccap)
        rows = packed48[cu]  # (chunk, ccap, 48)
        pl3 = jnp.transpose(
            rows.reshape(chunk, ccap, 3, 16), (0, 2, 1, 3)
        ).reshape(chunk, 3, 1, ccap * 16)
        xi = xi16[us][:, :, None]
        yi = yi16[us][:, :, None]
        zi = zi16[us][:, :, None]
        dx = xi - pl3[:, 0]
        dy = yi - pl3[:, 1]
        dz = zi - pl3[:, 2]
        rsq = dx * dx + dy * dy + dz * dz  # (chunk, 16, ccap*16)
        rsq = jnp.where(validu[us][:, :, None], rsq, fbig)
        mina = jnp.min(rsq, axis=1)
        mind = jnp.min(mina.reshape(chunk, ccap, 16), axis=2)
        keep = (mind <= cutsq) & (cu != sent16)
        nr = jnp.sum(keep, axis=1).astype(jnp.int32)
        key = jnp.where(keep, lpos, ccap + lpos)
        k2, v2 = jax.lax.sort((key, cu), num_keys=1, dimension=1,
                              is_stable=False)
        rc = min(rcap, ccap)
        out = jnp.where(k2[:, :rc] < ccap, v2[:, :rc], sent16)
        if rc < rcap:
            out = jnp.concatenate(
                [out, jnp.full((chunk, rcap - rc), sent16, jnp.int32)],
                axis=1,
            )
        return out, nr

    outs, nrs = jax.lax.map(prune_fn, starts_u)
    rows_out = outs.reshape(nu, rcap)
    numrows = nrs.reshape(nu)
    overflow = sovf | covf | kovf | jnp.any(numrows > rcap)
    stats = jnp.stack([
        jnp.max(total), jnp.max(n_dc), jnp.max(nk),
        jnp.zeros((), jnp.int32),
    ])
    return rows_out, numrows, stats, overflow


def compute_force_lj_rowlist(
    x: jnp.ndarray,  # (nrows, 3) — locals, ghosts, sentinel tail
    rows: jnp.ndarray,  # (nlocal_pad/16, rcap) int32 row ids
    numrows: jnp.ndarray,  # (nlocal_pad/16,) int32 real list lengths
    nlocal_pad: int,
    cutforcesq: float,
    sigma6: float,
    epsilon: float,
    kernel: str = "rowlist",  # "rowlist_pl" (GPU kernel) | "rowlist"
    interpret: bool = False,
) -> jnp.ndarray:
    """LJ force over packed row lists — the verlet scheme's fast path.
    A 16-atom row in ATOM ORDER plays the role the cluster scheme's j16
    plays: one (16 i-atoms x 16 j-atoms) pair tile per list entry, run
    by the same exact-list kernels as the cluster scheme (share=2: a
    unit's 16 atoms are two 8-atom i-clusters). Because the row lists
    cover every per-atom list entry at row granularity, the kernel's
    rsq < cutforce^2 mask computes the same pair set as the planar
    per-atom kernel (self pairs excluded by rsq > 0, sentinel padding
    by the cutoff). Reference analogue: the dedicated verlet SIMD
    kernel src/verletlist/force_lj-x86.c:21-112.

    Returns (nlocal_pad, 3) like compute_force_lj_full."""
    from mdbench_tpu.ops.pallas.lj_cluster import (
        lj_cluster_force_ilist_gpu,
        lj_cluster_force_xla_ilist,
    )

    assert x.shape[0] % 16 == 0 and nlocal_pad % 16 == 0
    xc = x[:, 0].reshape(-1, 8)
    yc = x[:, 1].reshape(-1, 8)
    zc = x[:, 2].reshape(-1, 8)
    n_clusters_pad = nlocal_pad // 8
    if kernel == "rowlist_pl":
        fx, fy, fz = lj_cluster_force_ilist_gpu(
            xc, yc, zc, rows, numrows, n_clusters_pad, cutforcesq, sigma6,
            epsilon, share=2, interpret=interpret,
        )
    else:
        fx, fy, fz = lj_cluster_force_xla_ilist(
            xc, yc, zc, rows, n_clusters_pad, cutforcesq, sigma6,
            epsilon, share=2,
        )
    return jnp.stack(
        [fx.reshape(-1), fy.reshape(-1), fz.reshape(-1)], axis=1
    )
