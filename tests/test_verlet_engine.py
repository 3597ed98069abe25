"""Verlet-list engine vs the dense O(N^2) oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdbench_tpu.config import Params
from mdbench_tpu.engine import Simulation
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.dense import lj_force_dense

pytestmark = pytest.mark.slow  # engine-level: minutes of XLA:CPU compile on 1 vCPU

def dense_forces_for(sim: Simulation) -> np.ndarray:
    """Dense oracle on the (sorted) initial positions of a Simulation."""
    x = sim._x0
    f, _, _ = lj_force_dense(
        jnp.asarray(x), sim.prd, sim.params.cutforce,
        sim.params.sigma6, sim.params.epsilon,
    )
    return np.asarray(f)


@pytest.mark.parametrize("half", [0, 1])
def test_first_force_matches_dense(half):
    # 4x4x4 -> box 6.7 sigma, cutoff 2.5 < box/2: min-image dense is exact
    p = Params(nx=4, ny=4, nz=4, half_neigh=half)
    sim = Simulation(p)
    f = sim.first_force()
    f_ref = dense_forces_for(sim)
    np.testing.assert_allclose(f, f_ref, rtol=1e-10, atol=1e-9)


def test_neighbor_counts_sane():
    p = Params(nx=4, ny=4, nz=4)
    sim = Simulation(p)
    state = sim.initial_state()
    nn = np.asarray(state.nlist.numneigh[: sim.nlocal])
    assert not bool(state.overflow)
    # FCC at rho=0.8442 with cutneigh=2.8: ~77 neighbors per atom
    assert 60 < nn.mean() < 90
    assert nn.min() > 0


def test_half_list_is_half():
    p_full = Params(nx=4, ny=4, nz=4, half_neigh=0)
    p_half = Params(nx=4, ny=4, nz=4, half_neigh=1)
    nn_full = np.asarray(
        Simulation(p_full).initial_state().nlist.numneigh
    ).sum()
    nn_half = np.asarray(
        Simulation(p_half).initial_state().nlist.numneigh
    ).sum()
    # ghost-mediated pairs appear once from each side in half lists, so
    # the half total is somewhat above full/2 but well below full
    assert nn_full * 0.5 <= nn_half < nn_full * 0.75


@pytest.mark.slow
def test_short_run_matches_dense_trajectory():
    """20 steps through the full engine == 20 steps of dense-force Verlet."""
    p = Params(nx=3, ny=3, nz=3, ntimes=20, reneigh_every=5)
    sim = Simulation(p)
    out = sim.run()
    assert not bool(out.state.overflow)

    # dense trajectory (same sorted initial conditions)
    x = jnp.asarray(sim._x0)
    v = jnp.asarray(sim._v0)
    prd = sim.prd

    def force(x):
        f, _, _ = lj_force_dense(x, prd, p.cutforce, p.sigma6, p.epsilon)
        return f

    f = force(x)
    temps = []
    for n in range(20):
        v = v + p.dtforce * f
        x = x + p.dt * v
        x = jnp.where(x < 0, x + jnp.asarray(prd, x.dtype), x)
        x = jnp.where(x >= jnp.asarray(prd, x.dtype), x - jnp.asarray(prd, x.dtype), x)
        f = force(x)
        v = v + p.dtforce * f
        temps.append(float(jnp.sum(v * v)) / (3 * sim.natoms - 3))

    np.testing.assert_allclose(out.temps, np.array(temps), rtol=1e-8)
    xe = np.asarray(out.state.x[: sim.nlocal])
    np.testing.assert_allclose(xe, np.asarray(x), rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_resort_every_preserves_trajectory():
    """Spatial resort (reference sortAtom every resort_every steps,
    neighbor.c:360-426) only permutes atom order — the trajectory must
    match the unsorted run to FP-summation-order noise."""
    base = dict(nx=4, ny=4, nz=4, ntimes=40, reneigh_every=10)
    out_plain = Simulation(Params(**base, resort_every=0)).run()
    out_sort = Simulation(Params(**base, resort_every=20)).run()
    np.testing.assert_allclose(out_sort.temps, out_plain.temps, rtol=1e-6)


@pytest.mark.slow
def test_reneighbor_preserves_energy_150_steps():
    """Longer run: TOTAL energy (KE + LJ potential) drift over 150 DP
    steps and several reneighbors stays within the velocity-Verlet
    O(dt^2) fluctuation band — the actual conservation check the
    reference leaves to its printed thermo trace (SURVEY §4)."""
    from mdbench_tpu.ops.lj import lj_energy_virial

    p = Params(nx=4, ny=4, nz=4, ntimes=150)
    sim = Simulation(p)

    def total_energy(state):
        ke = 0.5 * p.mass * float(
            np.sum(np.asarray(state.v[: sim.nlocal]) ** 2)
        )
        pe, _ = lj_energy_virial(
            state.x, state.nlist.neighbors, state.nlist.numneigh,
            sim.caps.nlocal_pad, sim.cutforcesq, p.sigma6, p.epsilon,
        )
        return ke + float(pe)

    e0 = total_energy(sim.initial_state())
    out = sim.run()
    e1 = total_energy(out.state)
    t = out.temps
    assert np.isfinite(t).all()
    assert t.max() < 10 * p.temp
    # relative drift bound: |E(150) - E(0)| / |E(0)|. The dominant term
    # is NOT the integrator but the reference's bare-truncation LJ
    # (no energy shift at the cutoff): pairs crossing r_c jump the
    # potential discontinuously, ~1.6e-3 over 150 hot steps. The bound
    # catches integrator/force bugs (wrong dtforce, misapplied Newton
    # pairs blow past this by orders of magnitude); exact force
    # correctness is pinned separately by the C-reference golden test.
    assert abs(e1 - e0) / abs(e0) < 5e-3, (e0, e1)


def test_rowlist_force_matches_planar():
    """kernel="rowlist" (the verlet fast path: packed 16-atom-row
    lists + exact-list kernel; XLA twin on CPU) computes the same
    forces as the planar per-atom kernel — the row lists are a
    row-granular superset, so the cutforce mask selects the identical
    pair set."""
    from mdbench_tpu.models.lattice import create_fcc_lattice

    p = Params(nx=4, ny=4, nz=4)
    x, v, _ = create_fcc_lattice(p)
    # perturb off the perfect lattice so forces are O(1), not
    # cancellation noise
    x = x + np.random.default_rng(5).normal(0, 0.03, x.shape)
    f_plain = Simulation(
        Params(nx=4, ny=4, nz=4, kernel="xla"), x=x, v=v, adjust=False
    ).first_force()
    f_rows = Simulation(
        Params(nx=4, ny=4, nz=4, kernel="rowlist"), x=x, v=v, adjust=False
    ).first_force()
    np.testing.assert_allclose(f_rows, f_plain, rtol=1e-10, atol=1e-10)


def test_direct_rowlists_match_per_atom_union():
    """derive_rowlists_from_cells (unit-granular, straight from the
    cell table) keeps a row iff some (unit atom, row atom) pair is
    within cutneigh — the same criterion as the union of exact
    per-atom verlet lists (derive_rowlists), so both must produce
    IDENTICAL ascending row lists."""
    import jax.numpy as jnp

    from mdbench_tpu.ops.cells import build_cells
    from mdbench_tpu.ops.verlet import (
        build_neighbors,
        derive_rowlists,
        derive_rowlists_from_cells,
    )

    p = Params(nx=5, ny=5, nz=5, kernel="rowlist")
    sim = Simulation(p)
    st = sim.initial_state()
    caps = sim.caps
    x = jnp.asarray(st.x)
    cl = build_cells(sim.grid, x)
    nl = build_neighbors(
        sim.grid, cl, x, st.types, sim.cutneighsq, sim.nlocal,
        caps.nlocal_pad, caps.maxneighs, half=False,
    )
    rcap = 96  # tiny box: unions reach ~70 rows
    rows_a, num_a, ovf_a = derive_rowlists(
        nl, caps.nlocal_pad, x.shape[0], rcap
    )
    rows_b, num_b, _nc, ovf_b = derive_rowlists_from_cells(
        sim.grid, cl, x, sim.nlocal, caps.nlocal_pad, rcap,
        p.cutneigh, brcap=24, ucol=8, zw=8, ccap=256,
    )
    assert not bool(ovf_a) and not bool(ovf_b)
    # all-padding units differ benignly: the per-atom oracle lists the
    # unit's own row (numrows 1), the direct build drops them entirely
    # (numrows 0 -> zero kernel work); real units must match exactly
    nreal = (sim.nlocal + 15) // 16
    np.testing.assert_array_equal(
        np.asarray(num_b)[:nreal], np.asarray(num_a)[:nreal]
    )
    np.testing.assert_array_equal(
        np.asarray(rows_b)[:nreal], np.asarray(rows_a)[:nreal]
    )
    assert int(np.asarray(num_b)[nreal:].sum()) == 0


def test_range_rowlists_match_per_atom_union():
    """derive_rowlists_from_ranges (sort-free contiguous-range build)
    must produce IDENTICAL ascending row lists to the per-atom verlet
    list union (same exact min-distance criterion; the range assembly
    is a provable candidate superset given the sortedness invariants)."""
    import jax.numpy as jnp

    from mdbench_tpu.ops.cells import build_cells
    from mdbench_tpu.ops.verlet import (
        build_neighbors,
        derive_rowlists,
        derive_rowlists_from_ranges,
    )

    p = Params(nx=5, ny=5, nz=5, kernel="rowlist")
    sim = Simulation(p)
    st = sim.initial_state()
    caps = sim.caps
    x = jnp.asarray(st.x)
    cl = build_cells(sim.grid, x)
    nl = build_neighbors(
        sim.grid, cl, x, st.types, sim.cutneighsq, sim.nlocal,
        caps.nlocal_pad, caps.maxneighs, half=False,
    )
    rcap = 96  # tiny box: unions reach ~70 rows
    rows_a, num_a, ovf_a = derive_rowlists(
        nl, caps.nlocal_pad, x.shape[0], rcap
    )
    rows_b, num_b, _nc, ovf_b = derive_rowlists_from_ranges(
        sim.grid, x, sim.nlocal, caps.nlocal_pad, caps.ghost, rcap,
        p.cutneigh, ucol=8, kcap=80, ccap=256,
    )
    assert not bool(ovf_a) and not bool(ovf_b)
    nreal = (sim.nlocal + 15) // 16
    np.testing.assert_array_equal(
        np.asarray(num_b)[:nreal], np.asarray(num_a)[:nreal]
    )
    np.testing.assert_array_equal(
        np.asarray(rows_b)[:nreal], np.asarray(rows_a)[:nreal]
    )
    assert int(np.asarray(num_b)[nreal:].sum()) == 0


@pytest.mark.slow
def test_rowlist_short_trajectory_matches_planar():
    base = dict(nx=3, ny=3, nz=3, ntimes=20, reneigh_every=5)
    out_a = Simulation(Params(**base, kernel="xla")).run()
    out_b = Simulation(Params(**base, kernel="rowlist")).run()
    np.testing.assert_allclose(out_b.temps, out_a.temps, rtol=1e-9)


def test_cell_table_matches_sequential_oracle():
    """build_cells' gather-form table == the reference's sequential
    binatoms fill (neighbor.c:329-358): bin b holds its atoms in row
    order, tail slots hold the sentinel row, overflow flags exactly
    when some interior bin exceeds capacity."""
    from mdbench_tpu.ops.cells import build_cells, coord_to_bin, make_cell_grid

    rng = np.random.default_rng(7)
    prd = (10.0, 8.0, 9.0)
    grid = make_cell_grid(prd, 2.8, rho=0.8, capacity=16)
    n = 700
    x = rng.uniform(-2.8, np.array(prd) + 2.8, size=(n, 3)).astype(np.float32)
    x[-1] = 1e30  # sentinel/padding row
    cl = jax.jit(lambda x: build_cells(grid, x))(jnp.asarray(x))
    ids = np.asarray(coord_to_bin(grid, jnp.asarray(x)))
    cells = np.asarray(cl.cells)
    assert not bool(cl.overflow)
    for b in range(grid.nbins):
        expect = np.flatnonzero(ids == b)
        got = cells[b][cells[b] != n - 1]
        np.testing.assert_array_equal(got, expect[: grid.capacity])
        assert np.all(cells[b][len(expect):] == n - 1)
    assert np.all(cells[grid.nbins] == n - 1)  # trap bin stays empty

    # overflow: jam many atoms into one bin
    x2 = np.full((64, 3), 1.0, np.float32)
    grid2 = make_cell_grid(prd, 2.8, rho=0.8, capacity=8)
    cl2 = jax.jit(lambda x: build_cells(grid2, x))(jnp.asarray(x2))
    assert bool(cl2.overflow)
