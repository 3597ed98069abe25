"""Device-side cell binning.

The reference bins atoms into a 3-D grid covering the box plus a ghost
halo, with a fixed atoms-per-bin capacity and a resize loop
(reference: src/verletlist/neighbor.c:64-184 setupNeighbor,
neighbor.c:298-358 coord2bin/binatoms). Device version: one argsort by bin
id + a ranked scatter produces the whole (nbins, capacity) cell table in
a few fused XLA ops; capacity overflow raises a flag the host handles by
growing and retracing (the analogue of the reference's resize loop).

Geometry differs deliberately from the reference (which targets cache
blocking): we use bins of edge >= cutneigh so a fixed 3x3x3 stencil
suffices, with exactly one margin ring of bins holding ghost atoms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mdbench_tpu.state import SENTINEL_COORD


class CellGrid(NamedTuple):
    """Static bin geometry (host-computed once per run)."""

    nbins_interior: tuple  # (nbx, nby, nbz) bins covering the box
    dims: tuple  # grid dims incl. one margin ring: (nbx+2, nby+2, nbz+2)
    binsize: tuple  # (bsx, bsy, bsz), each >= cutneigh
    capacity: int  # atoms per bin (padded)
    prd: tuple

    @property
    def nbins(self) -> int:
        d = self.dims
        return d[0] * d[1] * d[2]

    @property
    def stencil(self) -> np.ndarray:
        """Flat offsets of the 27-bin stencil."""
        _, ny, nz = self.dims
        offs = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    offs.append((dx * ny + dy) * nz + dz)
        return np.array(offs, dtype=np.int32)


def make_cell_grid(prd, cutneigh: float, rho: float, capacity: int = 0) -> CellGrid:
    """Choose bin geometry: bins no smaller than cutneigh so the 27-bin
    stencil is sufficient, one margin ring for ghosts."""
    nb = [max(1, int(math.floor(p / cutneigh))) for p in prd]
    bs = [p / n for p, n in zip(prd, nb)]
    if capacity <= 0:
        # expected atoms per bin x 1.35 safety, rounded up to 8. Kept
        # tight on purpose: the neighbor build's compaction sort runs
        # over 27*capacity lanes padded to a power of two, so capacity
        # 40 -> 32 halves the sort (1080 -> 864 pads 2048 -> 1024);
        # rare hot bins overflow into the grow-and-retry loop instead
        # of taxing every rebuild.
        mean = rho * bs[0] * bs[1] * bs[2]
        capacity = int(math.ceil(mean * 1.35 / 8.0)) * 8
    return CellGrid(
        nbins_interior=tuple(nb),
        dims=tuple(n + 2 for n in nb),
        binsize=tuple(bs),
        capacity=capacity,
        prd=tuple(prd),
    )


def coord_to_bin(grid: CellGrid, x: jnp.ndarray) -> jnp.ndarray:
    """Flat bin id per atom row (reference coord2bin, neighbor.c:298-327).

    Rows with sentinel coordinates (padding) map to the trap bin
    `grid.nbins` which the stencil never reads. Valid coordinates lie in
    [-cutneigh, prd + cutneigh) and land in [0, dims) after the +1 margin
    shift; anything else is clipped into the margin ring (a ghost exactly
    on the outer boundary still participates correctly).
    """
    bs = jnp.asarray(grid.binsize, x.dtype)
    dims = jnp.asarray(grid.dims, jnp.int32)
    b = jnp.floor(x / bs).astype(jnp.int32) + 1
    b = jnp.clip(b, 0, dims - 1)
    flat = (b[:, 0] * grid.dims[1] + b[:, 1]) * grid.dims[2] + b[:, 2]
    invalid = jnp.abs(x[:, 0]) >= SENTINEL_COORD * 0.5
    return jnp.where(invalid, grid.nbins, flat)


class CellList(NamedTuple):
    cells: jnp.ndarray  # (nbins + 1, capacity) int32 atom row indices
    bin_of: jnp.ndarray  # (nrows,) int32 flat bin id per atom row
    overflow: jnp.ndarray  # () bool


def build_cells(grid: CellGrid, x: jnp.ndarray) -> CellList:
    """Bin all rows of x (locals + ghosts + padding) into the cell table.

    Sort-based: argsort by bin id, rank within bin via searchsorted,
    ranked scatter. Deterministic: within a bin, atoms appear in row
    order (argsort is stable), mirroring the reference's sequential
    binatoms fill order (neighbor.c:329-358).
    """
    nrows = x.shape[0]
    sentinel_row = nrows - 1
    ids = coord_to_bin(grid, x)
    kbits = max(int(nrows - 1).bit_length(), 1)
    if (grid.nbins + 1) << kbits < 2**32:
        # single packed uint32 key (bin << kbits | row): one plain sort
        # instead of a variadic argsort, and the row bits make the sort
        # stable by construction
        key = (
            ids.astype(jnp.uint32) << kbits
        ) | jnp.arange(nrows, dtype=jnp.uint32)
        skey = jax.lax.sort(key)
        order = (skey & jnp.uint32((1 << kbits) - 1)).astype(jnp.int32)
        sorted_ids = (skey >> kbits).astype(ids.dtype)
    else:
        order = jnp.argsort(ids)  # stable
        sorted_ids = ids[order]
    starts = jnp.searchsorted(
        sorted_ids, jnp.arange(grid.nbins + 2, dtype=ids.dtype)
    ).astype(jnp.int32)

    # Gather-form table build (NOT a scatter of
    # cells.at[flat_pos].set(order)). After
    # the sort, bin b's atoms are order[starts[b] : starts[b+1]], so
    # slot (b, r) is a pure GATHER of order at starts[b] + r, masked by
    # the per-bin count — one (nbins+1, capacity) element gather.
    counts = starts[1:] - starts[:-1]  # (nbins + 1,)
    overflow = jnp.any(counts[: grid.nbins] > grid.capacity)
    slot = jnp.arange(grid.capacity, dtype=jnp.int32)
    pos = starts[:-1, None] + slot[None, :]  # (nbins + 1, capacity)
    live = slot[None, :] < counts[:, None]
    live = live & (jnp.arange(grid.nbins + 1)[:, None] < grid.nbins)
    cells = jnp.where(
        live,
        order.astype(jnp.int32)[jnp.minimum(pos, nrows - 1)],
        sentinel_row,
    )
    return CellList(
        cells=cells,
        bin_of=ids.astype(jnp.int32),
        overflow=overflow,
    )


def sort_atoms_device(grid: CellGrid, x, v, types, nlocal: int):
    """Device-side spatial resort of local atoms by bin id (reference
    sortAtom, neighbor.c:360-426, fired every resort_every steps): one
    argsort + row gathers inside the jitted reneighbor step. Restores
    gather locality that decays as atoms diffuse. Ghost rows and the
    sentinel are untouched (the caller rebuilds them right after)."""
    import jax.numpy as jnp

    xl = x[:nlocal]
    bs = grid.binsize
    dims = grid.dims
    bx = jnp.clip((xl[:, 0] / bs[0]).astype(jnp.int32) + 1, 0, dims[0] - 1)
    by = jnp.clip((xl[:, 1] / bs[1]).astype(jnp.int32) + 1, 0, dims[1] - 1)
    bz = jnp.clip((xl[:, 2] / bs[2]).astype(jnp.int32) + 1, 0, dims[2] - 1)
    flat = (bx * dims[1] + by) * dims[2] + bz
    perm = jnp.argsort(flat, stable=True)
    x = x.at[:nlocal].set(xl[perm])
    v = v.at[:nlocal].set(v[:nlocal][perm])
    types = types.at[:nlocal].set(types[:nlocal][perm])
    return x, v, types


def sort_atoms_host(grid: CellGrid, x: np.ndarray):
    """Spatial sort permutation by bin id (reference sortAtom,
    neighbor.c:360-426). Host-side, used at setup; improves gather
    locality of every later device kernel."""
    bs = np.asarray(grid.binsize)
    b = np.floor(x / bs).astype(np.int64) + 1
    dims = np.asarray(grid.dims)
    b = np.clip(b, 0, dims - 1)
    flat = (b[:, 0] * grid.dims[1] + b[:, 1]) * grid.dims[2] + b[:, 2]
    return np.argsort(flat, kind="stable")
