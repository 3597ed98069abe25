"""GROMACS-style MxN cluster machinery, re-dimensioned for JAX.

Reference scheme (src/clusterpair/): atoms grouped into M-atom i-clusters
and N-atom j-clusters sized to the SIMD width, bounding-box pruned
cluster-pair lists, interaction-mask self-exclusion
(neighbor.c:663-1021, force.h:34-95).

Re-derivation (SURVEY §2.5): M = 8 atoms per i-cluster, 16 per
j-cluster (two i-clusters). A group of G i-clusters shares one candidate
j-list built by bbox pruning; exact per-unit lists are derived from it
(derive_ilists) and feed the force kernels (ops/pallas/lj_cluster).
Differences from the reference, chosen deliberately for array code:

- clusters are built by one (column, z) sort over all atoms — the
  z-per-bin selection sort (neighbor.c:599-661) becomes a single
  lax.sort, and clusters are 8 consecutive atoms of a column;
- exclusion masks: the reference precomputes diagonal bitmask tables
  (atom.c:463-601). Here a mask is one vector compare (the self pair
  sits at rsq == 0), so there are no tables and no masked/unmasked list
  partition (neighbor.c:374-387);
- pair pruning uses bounding-box distance only (the reference adds an
  exact MxN check, neighbor.c:262-436); bbox-only is conservative.

Everything is fixed-capacity + overflow flags, rebuilt on device at
reneighbor boundaries.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mdbench_tpu.state import SENTINEL_COORD

M = 8  # atoms per i-cluster
N_J = 16  # atoms per j-cluster (M = N/2 geometry, reference force.h:74-91)
TILE_J = 8  # j16-clusters per group-window tile (ranges, stats)


class ClusterGrid(NamedTuple):
    """Static geometry for cluster binning and pair search."""

    col_dims: tuple  # (ncx, ncy) interior columns
    col_size: tuple  # (sx, sy) >= cutneigh
    # (col, zslab) search bins for cluster centers, 2-bin margin rings
    bin_dims: tuple  # (bx, by, bz) incl. margins
    bin_size: tuple  # (sx, sy, sz)
    bin_capacity: int  # clusters per search bin
    stencil: tuple  # (Wx, Wy, Wz) candidate window in bins
    slop_z: float  # assumed max half-z-extent of any cluster (checked)
    zspan_factor: float  # group z-extent headroom over the mean
    prd: tuple
    cutneigh: float
    # assumed max xy half-extent EXCESS over col_size/2 (checked):
    # full rebuilds chop clusters inside one column so the excess is 0
    # by construction, but between resorts (cheap rebuilds,
    # engine_cluster._reneigh_step_cheap) atoms vibrate past their
    # column edge; in a solid the amplitude is Lindemann-bounded
    # (~0.15 sigma), so a skin-sized margin covers any resort interval
    slop_xy: float = 0.35
    # budget for a whole GROUP's xy bbox extent growth past its build
    # column between resorts — sizes the pair-search window width
    # (win(sx + 2*drift_xy, ...)); the coverage check fires ovf_cov
    # when exceeded and the engine grows this margin (growing slop_xy
    # could never help: it dilates the window and the requirement
    # equally)
    drift_xy: float = 0.4

    @property
    def nbins(self) -> int:
        b = self.bin_dims
        return b[0] * b[1] * b[2]


def make_cluster_grid(
    prd, cutneigh: float, rho: float, group: int,
    bin_capacity: int = 0, slop_z: float = 0.0, zspan_factor: float = 1.4,
    slop_xy: float = 0.35, drift_xy: float = 0.4,
) -> ClusterGrid:
    ncx = max(1, int(math.floor(prd[0] / cutneigh)))
    ncy = max(1, int(math.floor(prd[1] / cutneigh)))
    sx, sy = prd[0] / ncx, prd[1] / ncy
    # COARSE z bins: within a column, j16 centers are near-evenly
    # spaced in z (16 consecutive z-sorted atoms each), so cut-sized z
    # bins hold ~1.2 j16 at capacity 8 — the candidate fetch then reads
    # ~7x more slots than clusters. Size z bins for ~4-5 j16 mean
    # occupancy instead: same coverage, ~3x fewer fetched rows and a
    # narrower sort in build_cluster_pairs (the stencil window below
    # adapts automatically).
    zbin_occ = 4.5  # target mean j16 per z bin
    sz_t = max(zbin_occ * N_J / (rho * sx * sy), 1e-6)
    nz = max(1, int(round(prd[2] / sz_t)))
    sz = prd[2] / nz
    # margins: cluster centers of ghost images lie within
    # cutneigh + extent/2 of the box; 2 bins cover that for bin >= cutneigh
    bin_dims = (ncx + 4, ncy + 4, nz + 4)
    if bin_capacity <= 0:
        mean16 = rho * sx * sy * sz / N_J
        bin_capacity = max(8, int(math.ceil(mean16 * 1.7 / 4.0)) * 4)
    if slop_z <= 0.0:
        # bound on a 16-atom j-cluster's half-z-extent (full 16-atom
        # span at mean density, which is ~2x the half-extent headroom);
        # bin_clusters verifies the bound at runtime and flags overflow
        # (-> slop growth) if violated
        slop_z = max(1.15 * N_J / (sx * sy * rho), 0.5)
    # candidate window: i-entity extent + 2*(cutneigh + j-half-extent).
    # xy half-extent of any cluster is col_size/2 exactly (clusters never
    # span columns); z half-extent is bounded by slop_z (checked).
    # worst-case group z extent: sparse columns (lattice/column aliasing)
    # can hold well below the mean atom count, stretching groups in z;
    # the pair search's coverage check flags it and the engine regrows
    # with a larger factor if this bound is ever exceeded
    zspan = group * M / (sx * sy * rho) * zspan_factor

    def win(extent, c, slop, binsize, maxdim):
        span = extent + 2.0 * (c + slop)
        return min(int(math.ceil(span / binsize)) + 1, maxdim)

    # xy extent budgets the group's bbox growth past its build column
    # between resorts (drift_xy — grown when the coverage check fires)
    wx = win(sx + 2 * drift_xy, cutneigh, sx / 2 + slop_xy, sx, bin_dims[0])
    wy = win(sy + 2 * drift_xy, cutneigh, sy / 2 + slop_xy, sy, bin_dims[1])
    wz = win(zspan, cutneigh, slop_z, sz, bin_dims[2])
    return ClusterGrid(
        col_dims=(ncx, ncy),
        col_size=(sx, sy),
        bin_dims=bin_dims,
        bin_size=(sx, sy, sz),
        bin_capacity=bin_capacity,
        stencil=(wx, wy, wz),
        slop_z=slop_z,
        zspan_factor=zspan_factor,
        prd=tuple(prd),
        cutneigh=cutneigh,
        slop_xy=slop_xy,
        drift_xy=drift_xy,
    )


class Clusters(NamedTuple):
    """Cluster-layout state. Coordinate planes are (C_total, 8) — local
    clusters first, then ghost slots, then one sentinel cluster (the
    reference's dummy_cj, atom.h:46-53). bbox is (C_total, 8) with
    columns [xmin xmax ymin ymax zmin zmax pad pad] so one row gather
    fetches a whole bbox."""

    xc: jnp.ndarray
    yc: jnp.ndarray
    zc: jnp.ndarray
    bbox: jnp.ndarray  # (C_total, 8)
    atom_id: jnp.ndarray  # (C_local, 8) int32 — original atom row, or -1 pad
    inv_map: jnp.ndarray  # (nlocal,) int32 — atom row -> cluster*8+slot
    # (the inverse of atom_id; lets the flatten step be a GATHER
    # instead of a column scatter)
    tc: jnp.ndarray  # (C_total, 8) atom types, FLOAT-encoded (0.0..T-1)
    # so type planes ride the same packed coordinate gathers/compares
    # (reference cl_type, clusterpair/atom.h:36; EXPLICIT_TYPES tables
    # atom.c:78-92)


class ClusterHalo(NamedTuple):
    border_map: jnp.ndarray  # (gcap,) int32 owner cluster
    shift_x: jnp.ndarray  # (gcap,)
    shift_y: jnp.ndarray
    shift_z: jnp.ndarray
    nghost: jnp.ndarray  # () int32
    overflow: jnp.ndarray


class ClusterPairList(NamedTuple):
    """Per-group shared j-cluster list (NG, 1, L), z-sorted and padded
    with the sentinel cluster id.
    `ranges` packs per-member tile windows: [0:G) start tile, [G:2G) end
    tile, [2G] the group's tile-loop bound.

    ijlist/nji (present on the kernel="ilist"/"ilist_pl" paths, else
    None): exact per-i-unit j16 lists (an i-unit = `share` consecutive
    i-clusters) derived from the group list by the exact atom-distance
    check (the reference's atomDistanceInRange, neighbor.c:262-436).
    They are several times tighter than the group windows, which is
    what sets the force kernel's pair count."""

    jlist: jnp.ndarray  # (NG, 1, L) int32
    ranges: jnp.ndarray  # (NG, 1, 2*G+1) int32
    nj: jnp.ndarray  # (NG,) int32
    overflow: jnp.ndarray
    ijlist: jnp.ndarray | None = None  # (NIC/share, icap) int32 j16 ids
    nji: jnp.ndarray | None = None  # (NIC/share,) int32
    iovf: jnp.ndarray | None = None  # () bool — nji > icap anywhere


def _zbits(z):
    """Monotonic int32 key for non-negative floats."""
    return jax.lax.bitcast_convert_type(z.astype(jnp.float32), jnp.int32)


def build_clusters(
    grid: ClusterGrid,
    x: jnp.ndarray,  # (nrows, 3) atom positions, locals [0, nlocal)
    nlocal: int,
    n_clusters_pad: int,  # local cluster capacity (multiple of group)
    ghost_capacity: int,  # ghost cluster capacity
    group: int = 1,  # pad each column to a multiple of `group` clusters
    types: jnp.ndarray | None = None,  # (>= nlocal,) int32 atom types
) -> tuple[Clusters, jnp.ndarray]:
    """Sort atoms by (column, z) and chop each COLUMN's run into 8-atom
    clusters, padding the last cluster of every column (reference:
    binAtoms + sortAtomsByZCoord + buildClusters, neighbor.c:599-753).
    Per-column chopping keeps cluster bboxes inside one column — a
    cluster spanning a raster-order column jump would have a box-sized
    bbox and wreck the pair search.

    Built by the inverse (gather) mapping: for each (cluster, slot)
    compute which sorted atom fills it — no scatter needed.
    Returns (clusters, overflow_flag).
    """
    dtype = x.dtype
    xl = x[:nlocal]
    sx, sy = grid.col_size
    ncx, ncy = grid.col_dims
    ncol = ncx * ncy
    cx = jnp.clip((xl[:, 0] / sx).astype(jnp.int32), 0, ncx - 1)
    cy = jnp.clip((xl[:, 1] / sy).astype(jnp.int32), 0, ncy - 1)
    col = cx * ncy + cy
    zb = _zbits(xl[:, 2])
    idx = jnp.arange(nlocal, dtype=jnp.int32)
    sorted_col, _, perm = jax.lax.sort((col, zb, idx), num_keys=2)

    # column ranges in the sorted order
    col_start = jnp.searchsorted(
        sorted_col, jnp.arange(ncol + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    col_count = col_start[1:] - col_start[:-1]  # (ncol,)
    # round each column's cluster count up to a multiple of `group` so
    # kernel groups never straddle columns (keeps group bboxes within one
    # column, which the pair-search window assumes)
    clusters_per_col = (col_count + (M - 1)) // M
    if group > 1:
        clusters_per_col = (
            (clusters_per_col + (group - 1)) // group * group
        )
    base = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(clusters_per_col).astype(jnp.int32)]
    )  # (ncol+1,) exclusive prefix
    n_clusters = base[-1]
    overflow = n_clusters > n_clusters_pad

    # inverse map: cluster row -> (column, rank-within-column)
    c_ids = jnp.arange(n_clusters_pad, dtype=jnp.int32)
    c_col = (
        jnp.searchsorted(base, c_ids, side="right").astype(jnp.int32) - 1
    )
    c_col = jnp.clip(c_col, 0, ncol - 1)
    within = c_ids - base[c_col]
    slot = jnp.arange(M, dtype=jnp.int32)[None, :]
    rank = within[:, None] * M + slot  # (n_clusters_pad, M)
    valid = (rank < col_count[c_col][:, None]) & (c_ids < n_clusters)[:, None]
    src = jnp.clip(col_start[c_col][:, None] + rank, 0, nlocal - 1)
    atom_rows = perm[src]  # (n_clusters_pad, M) original atom row

    # two sentinel rows: row count stays even so rows pair into 16-atom
    # j-clusters (M=N/2 geometry, reference force.h:74-91), and the last
    # PAIR is all-sentinel — the j16 list padding target
    total = n_clusters_pad + ghost_capacity + 2

    # padding coordinates carry a per-slot displacement so no two
    # padding atoms ever coincide: a partially-filled i-unit's padding
    # vs a partially-filled j16's padding at the SAME sentinel value
    # would give rsq == 0 <= cutsq and alias the exact-list min test
    # (derive_ilists), inflating nji for column-tail units. The offset
    # (>= 1e24) keeps |pad - anything| astronomically large while
    # |pad| stays sentinel-detectable (all checks use < SENTINEL/2).
    slot_rank = (
        jnp.arange(n_clusters_pad, dtype=jnp.float32)[:, None] * M
        + jnp.arange(M, dtype=jnp.float32)[None, :]
    )
    pad_coord = (SENTINEL_COORD * (1.0 + slot_rank * 1e-6)).astype(dtype)

    def plane(coord_col):
        v = jnp.where(valid, xl[atom_rows, coord_col], pad_coord)
        full = jnp.full((total, M), SENTINEL_COORD, dtype)
        return full.at[:n_clusters_pad].set(v)

    xc, yc, zc = plane(0), plane(1), plane(2)
    if types is None:
        tc = jnp.zeros((total, M), dtype)
    else:
        tv = jnp.where(valid, types[:nlocal][atom_rows].astype(dtype), 0.0)
        tc = jnp.zeros((total, M), dtype).at[:n_clusters_pad].set(tv)
    aid = jnp.where(valid, atom_rows, -1)
    # inverse mapping via one 1-D scatter (cheap, unlike 2-D scatters)
    slots = jnp.arange(n_clusters_pad * M, dtype=jnp.int32).reshape(
        n_clusters_pad, M
    )
    dest = jnp.where(valid, atom_rows, nlocal)
    inv = jnp.zeros((nlocal,), jnp.int32).at[dest.reshape(-1)].set(
        slots.reshape(-1), mode="drop"
    )
    bbox = compute_bboxes(xc, yc, zc)
    return Clusters(
        xc=xc, yc=yc, zc=zc, bbox=bbox, atom_id=aid, inv_map=inv, tc=tc
    ), overflow


def compute_bboxes(xc, yc, zc) -> jnp.ndarray:
    """Per-cluster bounding boxes (reference: buildClusters bbox fill,
    neighbor.c:739-752). Sentinel slots don't shrink the min side because
    +1e30 only inflates max — so mask them for max with -SENTINEL."""
    valid = jnp.abs(xc) < SENTINEL_COORD * 0.5

    def mm(p):
        lo = jnp.min(jnp.where(valid, p, SENTINEL_COORD), axis=1)
        hi = jnp.max(jnp.where(valid, p, -SENTINEL_COORD), axis=1)
        return lo, hi

    xlo, xhi = mm(xc)
    ylo, yhi = mm(yc)
    zlo, zhi = mm(zc)
    pad = jnp.zeros_like(xlo)
    return jnp.stack([xlo, xhi, ylo, yhi, zlo, zhi, pad, pad], axis=1)


def setup_cluster_pbc(
    clusters: Clusters,
    n_clusters_local: int,
    n_clusters_pad: int,
    ghost_capacity: int,  # ghost ROW capacity (must be even)
    prd,
    pbc,
    cutneigh: float,
) -> ClusterHalo:
    """Ghost creation at 16-atom j-cluster granularity (reference
    setupPbc creates whole-j-cluster images, src/clusterpair/pbc.c:
    144-299): a j16 PAIR of rows spawns an image for shift s iff its
    union bbox is within cutneigh of the corresponding boundary. Pair
    granularity keeps ghost rows paired with their real partner — a
    row-granular halo would pair images of different shifts into one
    j16 cluster and blow its bbox up to the box size."""
    assert ghost_capacity % 2 == 0
    gcap16 = ghost_capacity // 2
    n16 = n_clusters_pad // 2
    bb16 = make_j16_bboxes(clusters.bbox[:n_clusters_pad])  # (n16, 8)
    dtype = clusters.xc.dtype
    prd_v = np.asarray(prd, np.float64)
    pbc_v = np.asarray(pbc, np.int32)

    lo = jnp.stack([bb16[:, 0], bb16[:, 2], bb16[:, 4]], axis=1) < cutneigh
    hi = jnp.stack([bb16[:, 1], bb16[:, 3], bb16[:, 5]], axis=1) >= (
        jnp.asarray(prd_v, dtype) - cutneigh
    )

    shifts = np.array(
        [
            (sx, sy, sz)
            for sx in (-1, 0, 1)
            for sy in (-1, 0, 1)
            for sz in (-1, 0, 1)
            if (sx, sy, sz) != (0, 0, 0)
        ],
        dtype=np.int32,
    )
    pbc_ok = jnp.asarray(
        np.all((np.abs(shifts) == 0) | (pbc_v[None, :] != 0), axis=1)
    )
    sh = jnp.asarray(shifts)
    pos_ok = jnp.where(sh[None] == 1, lo[:, None, :], True)
    neg_ok = jnp.where(sh[None] == -1, hi[:, None, :], True)
    # all-sentinel pairs fail both boundary tests automatically
    valid = jnp.all(pos_ok & neg_ok, axis=2) & pbc_ok[None, :]

    flat = valid.reshape(-1)
    nghost = jnp.sum(flat).astype(jnp.int32)
    overflow = nghost > gcap16

    # compaction by ONE single-operand sort of the packed candidate
    # index (cluster*26 + shift): valid candidates keep their index
    # (order-preserving), dropped ones sort to the tail as the sentinel
    # value, in place of a cumsum + scatter.
    cand = jnp.arange(n16 * 26, dtype=jnp.int32)
    sentinel16 = clusters.xc.shape[0] // 2 - 1
    packed = jnp.sort(
        jnp.where(flat, cand, jnp.int32(sentinel16 * 26))
    )[:gcap16]
    border_map = packed // 26
    sidx = packed - border_map * 26
    shift_tab = jnp.asarray(
        shifts.astype(np.float64) * prd_v[None, :], dtype
    )
    sxv = shift_tab[sidx, 0]
    syv = shift_tab[sidx, 1]
    szv = shift_tab[sidx, 2]
    return ClusterHalo(
        border_map=border_map, shift_x=sxv, shift_y=syv, shift_z=szv,
        nghost=nghost, overflow=overflow,
    )


def update_cluster_pbc(
    clusters: Clusters, halo: ClusterHalo, n_clusters_pad: int,
    update_bbox: bool,
) -> Clusters:
    """Refresh ghost cluster planes from owners (reference updatePbc,
    clusterpair/pbc.c:45-113): row gather + shift. Each j16 ghost
    occupies two consecutive rows = the owner pair's rows shifted."""
    g0 = n_clusters_pad
    gcap16 = halo.border_map.shape[0]
    # expand j16 map to row granularity: ghost rows (2g, 2g+1) <- owner
    # rows (2*bm, 2*bm+1)
    row_map = (2 * halo.border_map[:, None]
               + jnp.arange(2, dtype=jnp.int32)[None, :]).reshape(-1)
    shx = jnp.repeat(halo.shift_x, 2)
    shy = jnp.repeat(halo.shift_y, 2)
    shz = jnp.repeat(halo.shift_z, 2)

    xg = clusters.xc[row_map] + shx[:, None]
    yg = clusters.yc[row_map] + shy[:, None]
    zg = clusters.zc[row_map] + shz[:, None]
    nrows_g = 2 * gcap16
    xc = clusters.xc.at[g0 : g0 + nrows_g].set(xg)
    yc = clusters.yc.at[g0 : g0 + nrows_g].set(yg)
    zc = clusters.zc.at[g0 : g0 + nrows_g].set(zg)
    if update_bbox:  # reneighbor-time call: also refresh bboxes + types
        bbg = clusters.bbox[row_map]
        shift8 = jnp.stack(
            [shx, shx, shy, shy, shz, shz,
             jnp.zeros_like(shx), jnp.zeros_like(shx)],
            axis=1,
        )
        bbox = clusters.bbox.at[g0 : g0 + nrows_g].set(bbg + shift8)
        tc = clusters.tc.at[g0 : g0 + nrows_g].set(clusters.tc[row_map])
    else:
        bbox = clusters.bbox
        tc = clusters.tc
    return clusters._replace(xc=xc, yc=yc, zc=zc, bbox=bbox, tc=tc)


def bin_clusters(grid: ClusterGrid, bb: jnp.ndarray):
    """Bin clusters (any granularity — callers pass 8-atom or 16-atom
    j-cluster bboxes) by bbox center into (col, zslab) search bins
    (reference binClusters, neighbor.c:875-1021) — the same sort +
    ranked scatter as the atom cell list. Also scatters each cluster's
    bbox into a (nbins+1, cap, 8) table so the pair search can gather
    candidate bboxes by BIN ROW (8x fewer gather rows than per-cluster
    gathers — XLA row gathers run at ~360M rows/s)."""
    ctr_x = 0.5 * (bb[:, 0] + bb[:, 1])
    ctr_y = 0.5 * (bb[:, 2] + bb[:, 3])
    ctr_z = 0.5 * (bb[:, 4] + bb[:, 5])
    dims = grid.bin_dims
    size = grid.bin_size
    bx = jnp.floor(ctr_x / size[0]).astype(jnp.int32) + 2
    by = jnp.floor(ctr_y / size[1]).astype(jnp.int32) + 2
    bz = jnp.floor(ctr_z / size[2]).astype(jnp.int32) + 2
    bx = jnp.clip(bx, 0, dims[0] - 1)
    by = jnp.clip(by, 0, dims[1] - 1)
    bz = jnp.clip(bz, 0, dims[2] - 1)
    flat = (bx * dims[1] + by) * dims[2] + bz
    # all-sentinel clusters have xmin=+1e30 (their CENTER misleadingly
    # averages to ~0, so test the bbox corner, not the center)
    invalid = ~(bb[:, 0] < SENTINEL_COORD * 0.25)  # NaN-safe
    ids = jnp.where(invalid, grid.nbins, flat)
    # the pair search assumes every cluster's z half-extent <= slop_z
    # and xy half-extent <= col_size/2 + slop_xy (between resorts,
    # drifted clusters can exceed the by-construction column bound)
    z_ext_ok = jnp.where(
        invalid,
        True,
        (0.5 * (bb[:, 5] - bb[:, 4]) <= grid.slop_z)
        & (0.5 * (bb[:, 1] - bb[:, 0]) <= size[0] / 2 + grid.slop_xy)
        & (0.5 * (bb[:, 3] - bb[:, 2]) <= size[1] / 2 + grid.slop_xy),
    )

    nrows = bb.shape[0]
    sentinel = nrows - 1
    order = jnp.argsort(ids)
    sorted_ids = ids[order]
    # rank within each equal-id run via boundary flags + running max —
    # a searchsorted here lowers to a sequential binary-search while
    # loop; this is three vector ops
    iota = jnp.arange(nrows, dtype=jnp.int32)
    newrun = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(newrun, iota, 0))
    rank = iota - run_start
    valid = sorted_ids < grid.nbins
    in_cap = rank < grid.bin_capacity
    ovf_cap = jnp.any(valid & ~in_cap)
    ovf_zext = jnp.any(~z_ext_ok)
    pos = jnp.where(
        valid & in_cap,
        sorted_ids.astype(jnp.int32) * grid.bin_capacity + rank,
        (grid.nbins + 1) * grid.bin_capacity,
    )
    cells = jnp.full(((grid.nbins + 1) * grid.bin_capacity,), sentinel, jnp.int32)
    cells = cells.at[pos].set(order.astype(jnp.int32), mode="drop")
    # bbox table aligned with `cells`, built by GATHER through the id
    # table instead of an 8-wide row scatter. Empty slots hold the sentinel row's empty bbox
    # (lo=+1e30, hi=-1e30), which the gap test excludes without an id
    # check. The cluster ID rides in pad slot 6 of each bbox row
    # (float-exact below 2^24), so the pair search's candidate fetch is
    # ONE by-bin-row gather instead of two. Rows are stored
    # COMPONENT-MAJOR ((nbins+1, 8, cap): all xlo of the bin's slots,
    # then all xhi, ...) so the pair search extracts contiguous
    # component planes with plain slices — transposing the table once
    # here replaces relayouting the much larger gathered candidate
    # stream every rebuild. The barrier forces the table to
    # MATERIALIZE: without it XLA composes this gather with
    # build_cluster_pairs' bb_cells[cand_bins] gather into per-cluster
    # row gathers — 8x the gather rows.
    bb_id = bb.at[:, 6].set(jnp.arange(nrows, dtype=bb.dtype))
    bb_cells = jax.lax.optimization_barrier(
        jnp.transpose(
            bb_id[cells].reshape(grid.nbins + 1, grid.bin_capacity, 8),
            (0, 2, 1),
        )
    )
    return (
        cells.reshape(grid.nbins + 1, grid.bin_capacity),
        bb_cells,  # (nbins+1, 8, cap)
        (ovf_cap, ovf_zext),
    )


def build_cluster_pairs(
    grid: ClusterGrid,
    cells: jnp.ndarray,  # (nbins+1, cap) — j16-cluster ids
    bb_cells: jnp.ndarray,  # (nbins+1, 8, cap) component-major bbox+id
    ibbox: jnp.ndarray,  # (>= n_clusters_pad, 8) i-cluster (8-atom) bboxes
    n_clusters_pad: int,
    group: int,
    list_capacity: int,
    chunk: int = 256,
    need_ranges: bool = True,
) -> ClusterPairList:
    """Shared j16-cluster list per group of `group` consecutive
    i-clusters (reference buildNeighbor, neighbor.c:176-436, re-shaped:
    per-group z-sorted union lists with per-i-cluster tile windows;
    bbox distance is the only prune).

    Compaction is a bitonic SORT, in place of a cumsum + dynamic-index
    scatter."""
    ng = n_clusters_pad // group
    dims = grid.bin_dims
    size = grid.bin_size
    cap = grid.bin_capacity
    wx, wy, wz = grid.stencil
    cutsq = grid.cutneigh * grid.cutneigh
    # note: entries dropped by the dsq test may still carry real cluster
    # ids past position nj in the sorted list; they are > cutneigh from
    # the whole group by construction, so the kernel's rsq mask zeroes
    # them even when a partial tile touches them

    bb_local = ibbox[:n_clusters_pad].reshape(ng, group, 8)
    # group bbox = union over members (sentinel members auto-inert)
    gmin_x = jnp.min(bb_local[:, :, 0], axis=1)
    gmax_x = jnp.max(bb_local[:, :, 1], axis=1)
    gmin_y = jnp.min(bb_local[:, :, 2], axis=1)
    gmax_y = jnp.max(bb_local[:, :, 3], axis=1)
    gmin_z = jnp.min(bb_local[:, :, 4], axis=1)
    gmax_z = jnp.max(bb_local[:, :, 5], axis=1)

    # candidate window start bins (dilate by cutneigh + half-extent slop:
    # binning is by center, so a j bbox reaches half-extent outside its
    # bin; xy half-extent <= col_size/2, z half-extent <= slop_z, checked
    # in bin_clusters)
    slop = (size[0] / 2 + grid.slop_xy, size[1] / 2 + grid.slop_xy,
            grid.slop_z)
    # packed-key compaction constants (need_ranges=False path)
    n16 = ibbox.shape[0] // 2
    sentinel_id = n16 - 1
    id_bits16 = n16 <= (1 << 16)
    zq_off = -(grid.cutneigh + grid.slop_z + 1.0)
    zq_scale = 16383.0 / (
        grid.prd[2] + 2.0 * (grid.cutneigh + grid.slop_z + 1.0)
    )
    offs = np.array(
        [
            ((ox * dims[1]) + oy) * dims[2] + oz
            for ox in range(wx)
            for oy in range(wy)
            for oz in range(wz)
        ],
        dtype=np.int32,
    )
    offs_j = jnp.asarray(offs)

    nj_dtype = jnp.int32

    def chunk_fn(g0):
        gs = g0 + jnp.arange(chunk, dtype=jnp.int32)
        real = gs < ng
        gsafe = jnp.where(real, gs, 0)
        mnx = gmin_x[gsafe]; mxx = gmax_x[gsafe]
        mny = gmin_y[gsafe]; mxy = gmax_y[gsafe]
        mnz = gmin_z[gsafe]; mxz = gmax_z[gsafe]

        bx0 = jnp.floor((mnx - grid.cutneigh - slop[0]) / size[0]).astype(jnp.int32) + 2
        by0 = jnp.floor((mny - grid.cutneigh - slop[1]) / size[1]).astype(jnp.int32) + 2
        bz0 = jnp.floor((mnz - grid.cutneigh - slop[2]) / size[2]).astype(jnp.int32) + 2
        bx0 = jnp.clip(bx0, 0, dims[0] - wx)
        by0 = jnp.clip(by0, 0, dims[1] - wy)
        bz0 = jnp.clip(bz0, 0, dims[2] - wz)
        # coverage check: window must reach the dilated max corner —
        # clamped to the last real bin (no cluster lives beyond the grid)
        bx1 = jnp.floor((mxx + grid.cutneigh + slop[0]) / size[0]).astype(jnp.int32) + 2
        by1 = jnp.floor((mxy + grid.cutneigh + slop[1]) / size[1]).astype(jnp.int32) + 2
        bz1 = jnp.floor((mxz + grid.cutneigh + slop[2]) / size[2]).astype(jnp.int32) + 2
        bx1 = jnp.minimum(bx1, dims[0] - 1)
        by1 = jnp.minimum(by1, dims[1] - 1)
        bz1 = jnp.minimum(bz1, dims[2] - 1)
        covered = (
            (bx1 - bx0 < wx) & (by1 - by0 < wy) & (bz1 - bz0 < wz)
        ) | ~real

        base = (bx0 * dims[1] + by0) * dims[2] + bz0  # (chunk,)
        cand_bins = base[:, None] + offs_j[None, :]  # (chunk, Wx*Wy*Wz)
        nwin = offs.shape[0]

        # bbox+id gather by FLAT BIN ROW (8*cap floats, component-major
        # within the row): because the table is pre-transposed,
        # component planes come out as CONTIGUOUS slices — no
        # per-candidate relayout at all. The id rides in pad slot 6, so
        # no separate id gather. End state: components planar on
        # (chunk, 8, ncand).
        g = bb_cells.reshape(-1, 8 * cap)[cand_bins]

        def comp(c):  # contiguous component plane (chunk, ncand)
            return g[:, :, c * cap : (c + 1) * cap].reshape(
                chunk, nwin * cap
            )

        # bbox-to-bbox distance vs group bbox
        def gap(lo_i, hi_i, lo_j, hi_j):
            return jnp.maximum(
                0.0, jnp.maximum(lo_i[:, None] - hi_j, lo_j - hi_i[:, None])
            )
        dx = gap(mnx, mxx, comp(0), comp(1))
        dy = gap(mny, mxy, comp(2), comp(3))
        zmin_raw = comp(4)
        dz = gap(mnz, mxz, zmin_raw, comp(5))
        dsq = dx * dx + dy * dy + dz * dz
        keep = (dsq <= cutsq) & real[:, None]  # empty slots fail dsq

        nj = jnp.sum(keep, axis=1).astype(nj_dtype)
        # Sort kept candidates by bbox zmin: each i-cluster's reachable
        # j's then form ONE contiguous segment of the group list, so the
        # kernel can skip tiles outside a per-i-cluster [start, end)
        # range — per-cluster pruning with group-amortized loads.
        # zmax rides along so the start bound can be exact (below).
        # With need_ranges=False (exact-list kernels ignore windows),
        # zmax stays out of the sort: every operand widens the bitonic.
        cand = comp(6).astype(jnp.int32)  # ids from pad slot 6
        zmin_j = jnp.where(keep, zmin_raw, SENTINEL_COORD)
        # is_stable=False everywhere: stability adds an iota operand to
        # the bitonic (~30% of the widest sort in the rebuild); ties
        # only occur between dropped/sentinel entries
        if not need_ranges:
            # exact-list path: z order is only a locality nicety (the
            # derive re-checks exactly), so the compaction runs as ONE
            # packed-int key [dropped:1][quantized z:15][id:16] — half
            # the widest sort in the rebuild — whenever ids fit 16 bits
            if id_bits16:
                zq = jnp.clip(
                    ((zmin_raw - zq_off) * zq_scale).astype(jnp.int32),
                    0, 16383,
                )
                key = jnp.where(
                    keep,
                    (zq << 16) | cand,
                    jnp.int32(1 << 30) + cand,
                )
                ks = jax.lax.sort(key, dimension=1, is_stable=False)
                ks = ks[:, :list_capacity]
                jl = jnp.where(
                    ks < (1 << 30), ks & 0xFFFF, sentinel_id
                )
            else:
                zs, jl_sorted = jax.lax.sort(
                    (zmin_j, cand), num_keys=1, is_stable=False
                )
                jl = jl_sorted[:, :list_capacity]
            ranges = jnp.zeros((chunk, 2 * group + 1), jnp.int32)
            ovf_nj = jnp.any(nj > list_capacity)
            ovf_cov = jnp.any(~covered)
            return jl, ranges, nj, ovf_nj, ovf_cov
        zmax_j = jnp.where(keep, comp(5), SENTINEL_COORD)
        zs, zx_sorted, jl_sorted = jax.lax.sort(
            (zmin_j, zmax_j, cand), num_keys=1, is_stable=False
        )
        jl = jl_sorted[:, :list_capacity]
        zs = zs[:, :list_capacity]
        zx_sorted = zx_sorted[:, :list_capacity]

        # per-member tile ranges (8 j16-clusters = 128 atoms per
        # tile). j needed iff zmax_j >= zmin_i - c and zmin_j <= zmax_i+c.
        # end is exact on the sorted zmin; for start, zmax is not monotone
        # in zmin order, but its running max is — so counting positions
        # whose PREFIX max zmax stays below the bound is exact too (the
        # counterpart of the reference's exact atomDistanceInRange
        # prune, neighbor.c:262-436, at j-cluster granularity; replaces
        # the old conservative 2*slop_z padding on the start side).
        rmax = jax.lax.cummax(zx_sorted, axis=1)
        bbm = bb_local[gsafe]  # (chunk, group, 8)
        zmin_i = bbm[:, :, 4]
        zmax_i = bbm[:, :, 5]
        lo = zmin_i - grid.cutneigh
        hi = zmax_i + grid.cutneigh
        start = jnp.sum(
            rmax[:, None, :] < lo[:, :, None], axis=2
        ).astype(jnp.int32)
        end = jnp.sum(
            zs[:, None, :] <= hi[:, :, None], axis=2
        ).astype(jnp.int32)
        end = jnp.minimum(end, jnp.minimum(nj, list_capacity)[:, None])
        start = jnp.minimum(start, end)
        start_t = start // TILE_J
        end_t = (end + TILE_J - 1) // TILE_J
        njg_g = jnp.max(end_t, axis=1, keepdims=True)  # (chunk, 1)
        ranges = jnp.concatenate([start_t, end_t, njg_g], axis=1)

        ovf_nj = jnp.any(nj > list_capacity)
        ovf_cov = jnp.any(~covered)
        return jl, ranges, nj, ovf_nj, ovf_cov

    ngpad = ((ng + chunk - 1) // chunk) * chunk
    starts = jnp.arange(0, ngpad, chunk, dtype=jnp.int32)
    jls, rgs, njs, ovf_njs, ovf_covs = jax.lax.map(chunk_fn, starts)
    jlist = jls.reshape(-1, list_capacity)[:ng].reshape(ng, 1, list_capacity)
    rdim = 2 * group + 1
    ranges = rgs.reshape(-1, rdim)[:ng].reshape(ng, 1, rdim)
    nj = njs.reshape(-1)[:ng]
    return ClusterPairList(
        jlist=jlist, ranges=ranges, nj=nj,
        overflow=jnp.stack([jnp.any(ovf_njs), jnp.any(ovf_covs)]),
    )


def derive_ilists(
    clusters: Clusters,
    pairs: ClusterPairList,
    n_clusters_pad: int,
    group: int,
    cutneigh: float,
    icap: int,
    chunk: int = 128,
    share: int = 1,
    bf16: bool = False,
) -> ClusterPairList:
    """Exact per-i-unit j16 lists, derived from the group-shared lists
    by the exact minimum atom-atom distance check (the reference's
    atomDistanceInRange prune, src/clusterpair/neighbor.c:262-436, at
    (share*8-atom i-unit) x (16-atom j-cluster) granularity, against
    cutneigh so the list survives a reneighbor interval).

    This feeds the exact-list force kernels (ilist_pl, ilist).
    `share` consecutive z-sorted i-clusters sharing one exact list
    trades list rows against padded pairs: share=2 halves the rows at a
    nearly identical padded-pair count, because z-adjacent i-clusters
    overlap almost completely in neighbors. The exact check costs one
    force-equivalent pass per rebuild — amortized over the reneighbor
    interval.

    Kept entries preserve the group list's z-sorted order (compaction is
    a stable sort on the drop flag). Dropped/padding slots hold the
    sentinel j16 id, whose ~1e30 coordinates fail the cutoff in the
    kernel naturally.

    bf16=True runs the exact check's dominant (chunk, i-atoms, Lk*16)
    distance math in bfloat16 after centering both sides on each unit's
    first atom (the centering bounds coordinate magnitudes to a few
    length units, so the bf16 rounding error is ~0.01 instead of ~0.1
    at raw box coordinates). The cutoff is inflated by a rigorous
    worst-case error bound, so bf16 keeps a SUPERSET of the exact lists
    — physics is untouched (the force kernel applies the exact f32
    cutoff), only a ~boundary-shell of extra j16 entries survives.
    Sentinel padding atoms are masked explicitly (their per-slot
    displacement, build_clusters, is invisible at bf16 precision)."""
    assert group % share == 0
    gs_units = group // share
    ng, _, L = pairs.jlist.shape
    cjn = clusters.xc.shape[0] // 2
    packed48 = jnp.concatenate(
        [clusters.xc.reshape(cjn, 16), clusters.yc.reshape(cjn, 16),
         clusters.zc.reshape(cjn, 16)],
        axis=1,
    )  # one 48-wide row fetch, not three
    sentinel16 = cjn - 1
    jl_all = pairs.jlist.reshape(ng, L)
    nj_all = pairs.nj
    xi_all = clusters.xc[:n_clusters_pad].reshape(ng, group * M)
    yi_all = clusters.yc[:n_clusters_pad].reshape(ng, group * M)
    zi_all = clusters.zc[:n_clusters_pad].reshape(ng, group * M)
    cutsq = cutneigh * cutneigh

    def make_chunk_fn(Lk):
        lpos = jnp.arange(Lk, dtype=jnp.int32)

        def chunk_fn(g0):
            gi = g0 + jnp.arange(chunk, dtype=jnp.int32)
            gsafe = jnp.where(gi < ng, gi, 0)
            jl = jl_all[gsafe][:, :Lk]  # (chunk, Lk)
            # j-atoms are flattened onto the minor axis (Lk*16) and the
            # per-j16 minimum is a two-stage min over it
            rows = packed48[jl]  # (chunk, Lk, 48)
            pl3 = jnp.transpose(
                rows.reshape(chunk, Lk, 3, 16), (0, 2, 1, 3)
            ).reshape(chunk, 3, 1, 1, Lk * 16)
            xj = pl3[:, 0]
            yj = pl3[:, 1]
            zj = pl3[:, 2]
            if bf16:
                # centered bf16 distance math with a rigorous-superset
                # inflated cutoff (see docstring). Centering on each
                # unit's FIRST atom keeps magnitudes ~O(unit extent +
                # cutneigh); sentinel atoms are pushed to +-BIG so
                # padding can never alias to rsq=0 at bf16 precision.
                S = SENTINEL_COORD * 0.5
                BIG = 3.0e4
                bft = jnp.bfloat16
                xi3 = xi_all[gsafe].reshape(chunk, gs_units, share * M)
                yi3 = yi_all[gsafe].reshape(chunk, gs_units, share * M)
                zi3 = zi_all[gsafe].reshape(chunk, gs_units, share * M)

                def cen_i(a3):
                    c = a3[:, :, 0:1]
                    real = jnp.abs(a3) < S
                    ac = jnp.where(real, a3 - c, -BIG)
                    # per-unit real-atom extent from the centering atom:
                    # the dynamic input to the rounding-error bound
                    ext = jnp.max(
                        jnp.where(real, jnp.abs(a3 - c), 0.0), axis=2
                    )
                    return ac.astype(bft)[..., None], c, ext

                def cen_j(ajp, c):
                    aj = ajp.reshape(chunk, 1, Lk * 16)
                    ac = jnp.where(jnp.abs(aj) < S, aj - c, BIG)
                    return ac.astype(bft)[:, :, None, :]

                xib, cx, bx = cen_i(xi3)
                yib, cy, by = cen_i(yi3)
                zib, cz, bz = cen_i(zi3)
                dx = xib - cen_j(xj, cx)
                dy = yib - cen_j(yj, cy)
                dz = zib - cen_j(zj, cz)
                rsq16 = dx * dx + dy * dy + dz * dz  # the big op, bf16
                mina16 = jnp.min(rsq16, axis=2)
                mind = jnp.min(
                    mina16.reshape(chunk, gs_units, Lk, 16), axis=3
                ).astype(xi3.dtype)
                # worst-case bf16 error bound, per unit: bfloat16 keeps
                # 8 significand bits, so round-to-nearest errs <=
                # |v|*2^-8. A keep-boundary pair has |xi_c| <= B_i (the
                # unit's real extent from its centering atom),
                # |xj_c| <= B_i + cutneigh, and |dx| <= cutneigh per
                # component; the two input roundings plus the bf16
                # subtraction's own rounding give a per-component
                # distance error <= (2 B_i + 2 cut)*2^-8, combined as
                # the component 2-norm; the square/sum chain adds <=
                # ~3 roundings relative (2^-5 used, generous)
                eps8 = 2.0 ** -8
                ex = (2.0 * bx + 2.0 * cutneigh) * eps8
                ey = (2.0 * by + 2.0 * cutneigh) * eps8
                ez = (2.0 * bz + 2.0 * cutneigh) * eps8
                err_r = jnp.sqrt(ex * ex + ey * ey + ez * ez)
                cut_eff = ((cutneigh + err_r) ** 2) * (1.0 + 2.0 ** -5)
                keep = (
                    (mind <= cut_eff[:, :, None])
                    & (lpos[None, None, :] < nj_all[gsafe][:, None, None])
                )
            else:
                # i-side sentinels flip sign (a select on the SMALL i
                # planes): i-pad vs j-pad pairs land at |dx| ~ 2e30
                # instead of aliasing to 0 when a ghost j16 carries an
                # exact copy of its owner's padding coordinates (the
                # box-period shift rounds away at sentinel magnitude,
                # defeating the per-slot displacement)
                S_half = SENTINEL_COORD * 0.5

                def iplane(a_all):
                    a = a_all[gsafe]
                    a = jnp.where(jnp.abs(a) < S_half, a, -a)
                    return a.reshape(chunk, gs_units, share * M, 1)

                xi = iplane(xi_all)
                yi = iplane(yi_all)
                zi = iplane(zi_all)
                dx = xi - xj
                dy = yi - yj
                dz = zi - zj
                rsq = dx * dx + dy * dy + dz * dz
                mina = jnp.min(rsq, axis=2)  # over i -> (chunk, u, Lk*16)
                mind = jnp.min(
                    mina.reshape(chunk, gs_units, Lk, 16), axis=3
                )  # per-j16 minor-dim min -> (chunk, gs_units, Lk)
                keep = (
                    (mind <= cutsq)
                    & (lpos[None, None, :] < nj_all[gsafe][:, None, None])
                )
            nji = jnp.sum(keep, axis=2).astype(jnp.int32)
            # stable compaction: kept entries first, z order kept. A
            # bitonic sort on a single packed key (drop-flag * Lk +
            # position) — in place of a cumsum + dynamic-index scatter
            key = jnp.where(keep, lpos, Lk + lpos)
            jlb = jnp.broadcast_to(jl[:, None, :], keep.shape)
            # keys are distinct positions, so an unstable sort is
            # already deterministic (is_stable would add an iota)
            sk, sj = jax.lax.sort(
                (key, jlb), num_keys=1, dimension=2, is_stable=False
            )
            ncap = min(icap, Lk)
            ijl = jnp.where(
                sk[:, :, :ncap] < Lk, sj[:, :, :ncap], sentinel16
            )
            if ncap < icap:
                ijl = jnp.concatenate(
                    [ijl, jnp.full(
                        (chunk, gs_units, icap - ncap), sentinel16,
                        jnp.int32,
                    )],
                    axis=2,
                )
            return ijl, nji

        return chunk_fn

    n_units = n_clusters_pad // share
    ngpad = ((ng + chunk - 1) // chunk) * chunk
    starts = jnp.arange(0, ngpad, chunk, dtype=jnp.int32)
    ijls, njis = jax.lax.map(make_chunk_fn(L), starts)
    ijlist = ijls.reshape(-1, icap)[:n_units]
    nji = njis.reshape(-1)[:n_units]
    return pairs._replace(
        ijlist=ijlist, nji=nji, iovf=jnp.any(nji > icap)
    )


def refresh_pair_ranges(
    clusters: Clusters,
    pairs: ClusterPairList,
    n_clusters_pad: int,
    group: int,
    cutneigh: float,
) -> ClusterPairList:
    """Prune pass (reference pruneNeighbor, neighbor.c:483-531): without
    re-binning or rebuilding lists, recompute the per-member tile windows
    from CURRENT coordinates so j-clusters that drifted out of range drop
    out of the compute windows. The list keeps its (near-sorted) order;
    the bounds stay exact for arbitrary order by using the prefix-max of
    zmax (start) and the suffix-min of zmin (end)."""
    ng, _, L = pairs.jlist.shape
    bbox = compute_bboxes(clusters.xc, clusters.yc, clusters.zc)
    bb16 = make_j16_bboxes(bbox)
    jl = pairs.jlist.reshape(ng, L)
    zmin_j = bb16[jl, 4]  # (ng, L)
    zmax_j = bb16[jl, 5]
    rmax = jax.lax.cummax(zmax_j, axis=1)
    rmin = jax.lax.cummin(zmin_j[:, ::-1], axis=1)[:, ::-1]

    bb_local = bbox[:n_clusters_pad].reshape(ng, group, 8)
    lo = bb_local[:, :, 4] - cutneigh  # (ng, group)
    hi = bb_local[:, :, 5] + cutneigh
    start = jnp.sum(rmax[:, None, :] < lo[:, :, None], axis=2).astype(jnp.int32)
    end = jnp.sum(rmin[:, None, :] <= hi[:, :, None], axis=2).astype(jnp.int32)
    end = jnp.minimum(end, jnp.minimum(pairs.nj, L)[:, None])
    start = jnp.minimum(start, end)
    start_t = start // TILE_J
    end_t = (end + TILE_J - 1) // TILE_J
    njg = jnp.max(end_t, axis=1, keepdims=True)
    ranges = jnp.concatenate([start_t, end_t, njg], axis=1).reshape(
        ng, 1, 2 * group + 1
    )
    return pairs._replace(ranges=ranges)


def make_j16_bboxes(bbox: jnp.ndarray) -> jnp.ndarray:
    """Combine row pairs (2k, 2k+1) into 16-atom j-cluster bboxes
    (the reference M=N/2 j-cluster derivation, defineJClusters,
    neighbor.c:755-873). Requires an even row count; per-column cluster
    counts are padded to multiples of GROUP=16 so pairs never straddle
    columns."""
    b0 = bbox[0::2]
    b1 = bbox[1::2]
    return jnp.stack(
        [
            jnp.minimum(b0[:, 0], b1[:, 0]),
            jnp.maximum(b0[:, 1], b1[:, 1]),
            jnp.minimum(b0[:, 2], b1[:, 2]),
            jnp.maximum(b0[:, 3], b1[:, 3]),
            jnp.minimum(b0[:, 4], b1[:, 4]),
            jnp.maximum(b0[:, 5], b1[:, 5]),
            jnp.zeros_like(b0[:, 0]),
            jnp.zeros_like(b0[:, 0]),
        ],
        axis=1,
    )
