"""Core simulation state pytrees.

The reference's mutable `Atom` struct (src/verletlist/atom.h:12-39,
src/clusterpair/atom.h:19-54) becomes immutable fixed-capacity pytrees:
SoA `(N, 3)` arrays, with local atoms first and ghost slots
appended, all shapes static under jit. Data-dependent counts (ghosts,
neighbors) live as device scalars plus padding sentinels; capacity
overflows raise flags that the host handles by growing and retracing
(the device analogue of the reference's realloc loops, atom.c:590-618,
neighbor.c:247-262).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from mdbench_tpu.config import Params


class Box(NamedTuple):
    """Orthorhombic periodic box; static per run."""

    xprd: float
    yprd: float
    zprd: float
    pbc: tuple  # (pbc_x, pbc_y, pbc_z) ints

    @property
    def prd(self) -> np.ndarray:
        return np.array([self.xprd, self.yprd, self.zprd], dtype=np.float64)


class System(NamedTuple):
    """Dynamic per-step state (carried through `lax.scan`).

    `x` has capacity for local + ghost atoms: rows [0, nlocal) are owned
    atoms, rows [nlocal, nlocal + ghost_capacity) are ghost images
    refreshed each step from `Halo`. `v`/`f` are local-only in meaning but
    share the padded local capacity.
    """

    x: jnp.ndarray  # (nlocal_pad + ghost_cap + 1, 3); last row = sentinel
    v: jnp.ndarray  # (nlocal_pad, 3)
    f: jnp.ndarray  # (nlocal_pad, 3)


class TypeTables(NamedTuple):
    """Per-type-pair interaction tables (reference: atom.c:78-89)."""

    types: jnp.ndarray  # (nlocal_pad + ghost_cap + 1,) int32
    epsilon: jnp.ndarray  # (ntypes, ntypes)
    sigma6: jnp.ndarray  # (ntypes, ntypes)
    cutforcesq: jnp.ndarray  # (ntypes, ntypes)
    cutneighsq: jnp.ndarray  # (ntypes, ntypes)


class Halo(NamedTuple):
    """Ghost-atom machinery (reference: pbc.c setupPbc/updatePbc).

    border_map[g] = owning local atom index; shift[g] = PBC shift vector
    (already multiplied by the box lengths). Padded to ghost capacity with
    border_map pointing at the sentinel row and zero shift.
    """

    border_map: jnp.ndarray  # (ghost_cap,) int32
    shift: jnp.ndarray  # (ghost_cap, 3) dtype
    nghost: jnp.ndarray  # () int32
    overflow: jnp.ndarray  # () bool — ghost capacity exceeded


class NeighborList(NamedTuple):
    """Padded fixed-width Verlet neighbor list
    (reference: neighbor.h:55-65; lists built in neighbor.c:186-264).

    `neighbors[i, k]` indexes into the System.x rows (locals + ghosts);
    padding entries point at the sentinel row (index = x.shape[0] - 1)
    whose coordinates are +1e30, so padded lanes fail the cutoff test
    naturally — the analogue of the reference's `dummy_cj` cluster.
    """

    neighbors: jnp.ndarray  # (nlocal_pad, maxneighs) int32
    numneigh: jnp.ndarray  # (nlocal_pad,) int32
    overflow: jnp.ndarray  # () bool — maxneighs exceeded
    # fast-path row lists (kernel="rowlist"/"rowlist_pl", LJ full
    # lists): packed 16-atom-row ids per 16-atom i-unit (ops/verlet
    # derive_rowlists*). None on the planar-XLA path.
    rows: jnp.ndarray | None = None  # (nlocal_pad/16, rcap) int32
    numrows: jnp.ndarray | None = None  # (nlocal_pad/16,) int32
    ncmax: jnp.ndarray | None = None  # () observed post-bbox candidate
    # maximum (drives ccap calibration)


def make_box(params: Params) -> Box:
    return Box(
        xprd=params.xprd,
        yprd=params.yprd,
        zprd=params.zprd,
        pbc=(params.pbc_x, params.pbc_y, params.pbc_z),
    )


SENTINEL_COORD = 1.0e30


def build_system(
    params: Params,
    x: np.ndarray,
    v: np.ndarray,
    types: np.ndarray,
    ghost_capacity: int,
    nlocal_pad: Optional[int] = None,
) -> tuple[System, TypeTables, int]:
    """Assemble device state from host arrays.

    Local rows are padded to `nlocal_pad` (default: next multiple of 8)
    with sentinel coordinates and zero velocity; ghost slots + one final
    sentinel row are appended to `x`. Returns (system, tables, nlocal).
    """
    dtype = params.dtype
    nlocal = x.shape[0]
    if nlocal_pad is None:
        nlocal_pad = ((nlocal + 7) // 8) * 8

    xp = np.full((nlocal_pad + ghost_capacity + 1, 3), SENTINEL_COORD, np.float64)
    xp[:nlocal] = x
    vp = np.zeros((nlocal_pad, 3), np.float64)
    vp[:nlocal] = v
    fp = np.zeros((nlocal_pad, 3), np.float64)

    tp = np.zeros(nlocal_pad + ghost_capacity + 1, np.int32)
    tp[:nlocal] = types

    nt = params.ntypes
    eps = np.full((nt, nt), params.epsilon, np.float64)
    sig6 = np.full((nt, nt), params.sigma6, np.float64)
    cfsq = np.full((nt, nt), params.cutforce**2, np.float64)
    cnsq = np.full((nt, nt), params.cutneigh**2, np.float64)

    system = System(
        x=jnp.asarray(xp, dtype),
        v=jnp.asarray(vp, dtype),
        f=jnp.asarray(fp, dtype),
    )
    tables = TypeTables(
        types=jnp.asarray(tp),
        epsilon=jnp.asarray(eps, dtype),
        sigma6=jnp.asarray(sig6, dtype),
        cutforcesq=jnp.asarray(cfsq, dtype),
        cutneighsq=jnp.asarray(cnsq, dtype),
    )
    return system, tables, nlocal
