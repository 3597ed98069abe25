"""Cluster-pair scheme vs the dense oracle (CPU, XLA kernel path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdbench_tpu.config import Params
from mdbench_tpu.engine_cluster import ClusterSimulation
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.dense import lj_force_dense

pytestmark = pytest.mark.slow  # engine-level: minutes of XLA:CPU compile on 1 vCPU

def test_cluster_first_force_matches_dense():
    p = Params(nx=4, ny=4, nz=4, kernel="xla")
    sim = ClusterSimulation(p)
    f = sim.first_force_atoms()
    f_ref, _, _ = lj_force_dense(
        jnp.asarray(sim._x0), sim.prd, p.cutforce, p.sigma6, p.epsilon
    )
    np.testing.assert_allclose(f, np.asarray(f_ref), rtol=1e-9, atol=1e-9)


def test_cluster_short_run_matches_verlet_engine():
    """20 steps of the cluster engine == 20 steps of the verlet engine."""
    from mdbench_tpu.engine import Simulation

    pv = Params(nx=4, ny=4, nz=4, ntimes=20, reneigh_every=5)
    pc = Params(nx=4, ny=4, nz=4, ntimes=20, reneigh_every=5, kernel="xla")
    # disable the verlet engine's setup sort so both start identically
    out_v = Simulation(pv).run()
    out_c = ClusterSimulation(pc).run()
    np.testing.assert_allclose(out_c.temps, out_v.temps, rtol=1e-8)
    np.testing.assert_allclose(out_c.press, out_v.press, rtol=1e-8)
    assert not np.asarray(out_c.state.overflow).any()


def test_cluster_multitype_matches_dense_and_pallas():
    """EXPLICIT_TYPES in the cluster scheme (reference clusterpair/
    atom.c:78-92): two atom types with NON-uniform pair tables, checked
    against the typed dense oracle."""
    from mdbench_tpu.ops.dense import lj_force_dense_typed
    from mdbench_tpu.state import TypeTables

    p = Params(nx=3, ny=3, nz=3, ntypes=2, kernel="xla")
    x, v, _ = create_fcc_lattice(p)
    rng = np.random.RandomState(7)
    types = rng.randint(0, 2, x.shape[0]).astype(np.int32)
    eps = np.array([[1.0, 0.7], [0.7, 1.3]])
    sig = np.array([[1.0, 0.95], [0.95, 1.05]])
    sig6 = sig**6
    cutsq = np.full((2, 2), p.cutforce**2)
    tables = (eps, sig6, cutsq)

    sim = ClusterSimulation(p, x=x, v=v, types=types, tables=tables)
    f = sim.first_force_atoms()
    tt = TypeTables(
        types=jnp.asarray(types),
        epsilon=jnp.asarray(eps), sigma6=jnp.asarray(sig6),
        cutforcesq=jnp.asarray(cutsq), cutneighsq=jnp.asarray(cutsq),
    )
    f_ref = lj_force_dense_typed(
        jnp.asarray(x), jnp.asarray(types), sim.prd, tt
    )
    np.testing.assert_allclose(f, np.asarray(f_ref), rtol=1e-9, atol=1e-9)


def test_cluster_two_atomtype_dmp_matches_verlet():
    """The two-atomtype copper .dmp (reference data/) runs through the
    cluster scheme and matches the verlet engine (EXPLICIT_TYPES
    end-to-end parity)."""
    from mdbench_tpu.engine import Simulation

    path = ("/root/reference/data/copper_melting/"
            "input_lj_cu_two_atomtypes_20x20x20.dmp")
    pv = Params(input_file=path, ntimes=6, reneigh_every=3)
    pc = Params(input_file=path, ntimes=6, reneigh_every=3, kernel="xla")
    out_v = Simulation(pv).run()
    out_c = ClusterSimulation(pc).run()
    assert out_v.temps.shape == out_c.temps.shape
    np.testing.assert_allclose(out_c.temps, out_v.temps, rtol=1e-8)


def test_cluster_prune_pass_preserves_trajectory():
    """pruneNeighbor analogue: the in-interval list refresh must not
    change physics (it may only drop pairs beyond cutneigh). Uses the
    exact-list kernel, whose lists the prune re-derives."""
    base = dict(nx=3, ny=3, nz=3, ntimes=8, reneigh_every=8,
                kernel="ilist")
    out_noprune = ClusterSimulation(Params(**base, prune_every=0)).run()
    out_prune = ClusterSimulation(Params(**base, prune_every=3)).run()
    np.testing.assert_allclose(
        out_prune.temps, out_noprune.temps, rtol=1e-12, atol=0
    )
    # and the pruned run stays correct vs the verlet engine
    from mdbench_tpu.engine import Simulation

    out_v = Simulation(Params(nx=3, ny=3, nz=3, ntimes=8,
                              reneigh_every=8)).run()
    np.testing.assert_allclose(out_prune.temps, out_v.temps, rtol=1e-8)


def test_cluster_half_neigh_matches_full():
    """Newton half-pair cluster kernel (param.half_neigh axis, reference
    clusterpair/force_lj.c HalfNeigh kernels): first forces and a short
    trajectory must match the full-pair kernel."""
    p_full = Params(nx=4, ny=4, nz=4, kernel="xla", half_neigh=0)
    p_half = Params(nx=4, ny=4, nz=4, kernel="xla", half_neigh=1)
    f_full = ClusterSimulation(p_full).first_force_atoms()
    f_half = ClusterSimulation(p_half).first_force_atoms()
    np.testing.assert_allclose(f_half, f_full, rtol=1e-9, atol=1e-10)

    pf = Params(nx=3, ny=3, nz=3, ntimes=10, reneigh_every=5,
                kernel="xla", half_neigh=0)
    ph = Params(nx=3, ny=3, nz=3, ntimes=10, reneigh_every=5,
                kernel="xla", half_neigh=1)
    out_f = ClusterSimulation(pf).run()
    out_h = ClusterSimulation(ph).run()
    np.testing.assert_allclose(out_h.temps, out_f.temps, rtol=1e-9)


def test_cluster_half_neigh_multitype():
    """Half-pair axis composes with EXPLICIT_TYPES."""
    p = Params(nx=3, ny=3, nz=3, ntypes=2, kernel="xla")
    x, v, _ = create_fcc_lattice(p)
    rng = np.random.RandomState(3)
    types = rng.randint(0, 2, x.shape[0]).astype(np.int32)
    eps = np.array([[1.0, 0.8], [0.8, 1.2]])
    sig6 = np.array([[1.0, 0.9], [0.9, 1.1]]) ** 6
    cutsq = np.full((2, 2), p.cutforce**2)
    f_full = ClusterSimulation(
        p, x=x, v=v, types=types, tables=(eps, sig6, cutsq)
    ).first_force_atoms()
    ph = Params(nx=3, ny=3, nz=3, ntypes=2, kernel="xla", half_neigh=1)
    f_half = ClusterSimulation(
        ph, x=x, v=v, types=types, tables=(eps, sig6, cutsq)
    ).first_force_atoms()
    np.testing.assert_allclose(f_half, f_full, rtol=1e-9, atol=1e-10)


def test_cluster_stats_exact_pair_count():
    """compute_cluster_stats counts exactly the pairs the kernel windows
    touch — cross-checked against a dense periodic pair count
    (reference clusterpair/stats.c counters)."""
    from mdbench_tpu.engine_cluster import GROUP
    from mdbench_tpu.ops.dense import _pairwise_min_image
    from mdbench_tpu.stats import compute_cluster_stats

    p = Params(nx=4, ny=4, nz=4, kernel="xla")
    sim = ClusterSimulation(p)
    st = sim.initial_state()
    cs = compute_cluster_stats(
        st.clusters, st.pairs, sim.n_clusters_pad, GROUP,
        p.cutforce**2, p.cutneigh**2,
    )
    x = jnp.asarray(sim._x0)
    d = _pairwise_min_image(x, sim.prd)
    rsq = np.asarray((d * d).sum(-1))
    n = x.shape[0]
    m = (rsq < p.cutforce**2) & ~np.eye(n, dtype=bool)
    assert cs["pairs_within_cutforce"] == int(m.sum())
    mn = (rsq < p.cutneigh**2) & ~np.eye(n, dtype=bool)
    assert cs["pairs_within_cutneigh"] == int(mn.sum())
    assert cs["clusters_within_cutoff"] <= cs["clusters_processed"]


def test_cluster_capacity_overflow_recovers():
    """Force a tiny list capacity; engine must grow and still be right."""
    p = Params(nx=3, ny=3, nz=3, ntimes=5, reneigh_every=5, kernel="xla")
    sim = ClusterSimulation(p)
    sim.list_cap = 16  # far too small on purpose
    out = sim.run(max_retries=8)
    assert not np.asarray(out.state.overflow).any()
    assert np.isfinite(out.temps).all()
