"""Multi-chip domain decomposition: sharded vs single-device parity on
the 8-device virtual CPU mesh (SURVEY §4: 'multi-node without a real
cluster')."""


import jax
import numpy as np
import pytest

from mdbench_tpu.config import Params

pytestmark = pytest.mark.slow  # trajectory/engine tier: run with the full suite


def test_domain_engine_matches_single_device():
    """Production slab engine (migration + ICI halo exchange + per-device
    verlet lists) vs the single-chip engine: full trajectory parity over
    multiple reneighbor intervals on the 8-device CPU mesh."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    p1 = Params(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10)
    p2 = Params(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10)
    out_single = Simulation(p1).run()
    dom = DomainSimulation(p2, ndev=ndev)
    out_dom = dom.run()
    np.testing.assert_allclose(
        out_dom.temps, out_single.temps, rtol=1e-8, atol=1e-12
    )


def test_domain_engine_eam_matches_single_device():
    """EAM in the domain engine: the two-pass force with the ghost-fp
    dependency needs a mid-force fp ppermute over the mesh (cross-chip
    force_eam.c:117-120). Trajectory parity vs the single-chip EAM
    engine across rebuilds."""
    from mdbench_tpu.config import FF_EAM
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 2
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(
        nx=6, ny=6, nz=6, ntimes=10, reneigh_every=5,
        force_field=FF_EAM, eam_file="/root/reference/data/Cu_u3.eam",
    )
    out_s = Simulation(mk()).run()
    dom = DomainSimulation(mk(), ndev=ndev)
    out_d = dom.run()
    assert int(np.asarray(out_d.state.nlocal).sum()) == dom.natoms
    np.testing.assert_allclose(out_d.temps, out_s.temps, rtol=1e-8)


def test_domain_engine_eam_poly_matches_single_device():
    """The gather-free polynomial EAM axis (eam_eval=poly) composes
    with the domain engine's mid-force fp ppermute: parity vs the
    single-chip poly path."""
    from mdbench_tpu.config import FF_EAM
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 2
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(
        nx=6, ny=6, nz=6, ntimes=10, reneigh_every=5,
        force_field=FF_EAM, eam_file="/root/reference/data/Cu_u3.eam",
        eam_eval="poly",
    )
    out_s = Simulation(mk()).run()
    dom = DomainSimulation(mk(), ndev=ndev)
    assert dom.eam_poly is not None
    out_d = dom.run()
    np.testing.assert_allclose(out_d.temps, out_s.temps, rtol=1e-8)


def test_cluster_domain_matches_single_device():
    """Cluster scheme over the device mesh (parallel/cluster_domain):
    trajectory parity vs the single-chip cluster engine across rebuild
    intervals, including j16-granular cross-chip ghosts and atom
    migration."""
    from mdbench_tpu.engine_cluster import ClusterSimulation
    from mdbench_tpu.parallel.cluster_domain import ClusterDomainSimulation

    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=16, ny=4, nz=4, ntimes=20, reneigh_every=10,
                        kernel="xla")
    p = mk()
    if p.xprd / ndev < p.cutneigh:
        pytest.skip("slab under cutoff")
    dom = ClusterDomainSimulation(mk(), ndev=ndev)
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = ClusterSimulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8)


def test_domain_overflow_recovery():
    """Domain engines grow-and-retry on capacity overflow instead of
    hard-failing (the multi-chip analogue of the single-chip engines'
    grow-and-retrace)."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 2
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5)
    dom = DomainSimulation(mk(), ndev=ndev)
    dom.maxneighs = 16  # force neighbor-list overflow on purpose
    out = dom.run()
    assert dom.maxneighs > 16  # grew
    out_s = Simulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8)


def test_capacity_plan_10m_atoms_8dev():
    """The 10M-atom config must PLAN well within one device's memory on
    an 8-device mesh. (Execution at that scale needs real cards;
    correctness of the engine is covered by the parity tests above and
    the scaled smoke below.)"""
    from mdbench_tpu.parallel.verlet_domain import plan_capacities

    # 10.1M atoms: 4 * 136 * 136 * 136 FCC cells
    p = Params(nx=136, ny=136, nz=136, precision="sp")
    natoms = 4 * p.nx * p.ny * p.nz
    assert natoms >= 10_000_000
    plan = plan_capacities(p, 8, natoms)
    assert plan["slab_ok"]
    assert plan["bytes_per_device"] < 16 * 1024**3 * 0.5, plan
    # and leave room for XLA scratch: under 4 GB is comfortable
    assert plan["bytes_per_device"] < 4 * 1024**3, plan


def test_domain_engine_quarter_million_smoke():
    """Scaled-down BASELINE multi-chip exercise on the CPU mesh: 262k
    atoms over 8 slabs, a few steps across one rebuild, atom
    conservation + finite thermo. (The 10M-atom run itself is gated on
    real hardware; set MDBENCH_BIG=1 to run it here.)"""
    import os

    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    if os.environ.get("MDBENCH_BIG"):
        p = Params(nx=136, ny=136, nz=136, ntimes=2, reneigh_every=2,
                   precision="sp")
    else:
        p = Params(nx=128, ny=16, nz=32, ntimes=4, reneigh_every=2,
                   precision="sp")
    dom = DomainSimulation(p, ndev=8)
    out = dom.run()
    assert np.isfinite(out.temps).all()
    assert int(np.asarray(out.state.nlocal).sum()) == dom.natoms


@pytest.mark.parametrize("px,py", [(2, 2), (4, 2)])
def test_domain2d_matches_single_device(px, py):
    """2-D pencil decomposition (staged x/y halo exchange incl. corner
    coverage) vs the single-chip engine: trajectory parity over several
    rebuild intervals on the virtual CPU mesh."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain2d import Domain2DSimulation

    if len(jax.devices()) < px * py:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=10, ny=10, nz=4, ntimes=20, reneigh_every=10)
    p = mk()
    if p.xprd / px < p.cutneigh or p.yprd / py < p.cutneigh:
        pytest.skip("pencil under cutoff")
    dom = Domain2DSimulation(mk(), px=px, py=py)
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = Simulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8,
                               atol=1e-12)


def test_domain2d_eam_matches_single_device():
    """EAM over the 2-D pencil mesh: the fp ghost refresh stages like
    the coordinate refresh (local z, x ppermute, y ppermute covering
    corners). Trajectory parity vs the single-chip EAM engine."""
    from mdbench_tpu.config import FF_EAM
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain2d import Domain2DSimulation

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    mk = lambda: Params(
        nx=8, ny=8, nz=4, ntimes=10, reneigh_every=5,
        force_field=FF_EAM, eam_file="/root/reference/data/Cu_u3.eam",
    )
    dom = Domain2DSimulation(mk(), px=2, py=2)
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = Simulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8)


def test_domain3d_eam_matches_single_device():
    """EAM over the 3-D brick mesh: the fp refresh is three staged
    ppermute hops with the coordinate face maps. Trajectory parity vs
    the single-chip EAM engine on a 2x2x2 virtual mesh."""
    from mdbench_tpu.config import FF_EAM
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain3d import Domain3DSimulation

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    mk = lambda: Params(
        nx=4, ny=4, nz=4, ntimes=10, reneigh_every=5,
        force_field=FF_EAM, eam_file="/root/reference/data/Cu_u3.eam",
    )
    dom = Domain3DSimulation(mk(), 2, 2, 2)
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = Simulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8)


@pytest.mark.parametrize("pdims", [(2, 2, 2), (2, 2, 1), (1, 1, 2)])
def test_domain3d_matches_single_device(pdims):
    """3-D brick decomposition: staged 3-axis migration + halo exchange.
    Mesh axes of size 1 degenerate to local periodic wrap through the
    self-ppermute, so one engine covers 1-D/2-D/3-D."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain3d import Domain3DSimulation

    px, py, pz = pdims
    if len(jax.devices()) < px * py * pz:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=10, ny=10, nz=10, ntimes=20, reneigh_every=10)
    p = mk()
    if (p.xprd / px < p.cutneigh or p.yprd / py < p.cutneigh
            or p.zprd / pz < p.cutneigh):
        pytest.skip("brick under cutoff")
    dom = Domain3DSimulation(mk(), px=px, py=py, pz=pz)
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = Simulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-8,
                               atol=1e-12)


def test_domain_engine_8dev():
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    p = Params(nx=32, ny=3, nz=3, ntimes=20, reneigh_every=10)
    dom = DomainSimulation(p, ndev=8)
    out = dom.run()
    assert np.isfinite(out.temps).all()
    # atom conservation across migration
    assert int(np.asarray(out.state.nlocal).sum()) == dom.natoms


def test_domain_rowlist_matches_single_device():
    """Domain engine with the per-device rowlist fast path (resort ->
    cell-sorted ghosts -> direct row build -> exact-list kernel, all
    under shard_map) vs the single-chip rowlist engine: trajectory
    parity on the CPU mesh. Tolerance is FP-summation-order noise
    (different row partitions), not physics."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10,
                        kernel="rowlist")
    out_single = Simulation(mk()).run()
    dom = DomainSimulation(mk(), ndev=ndev)
    out_dom = dom.run()
    np.testing.assert_allclose(
        out_dom.temps, out_single.temps, rtol=1e-6, atol=1e-10
    )


def test_cluster_domain_ilist_matches_single_device():
    """Cluster domain engine on its DEFAULT exact-list path (derive +
    ilist kernel per device, under shard_map) vs the single-chip
    cluster engine on its matching ilist path."""
    from mdbench_tpu.engine_cluster import ClusterSimulation
    from mdbench_tpu.parallel.cluster_domain import ClusterDomainSimulation

    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=16, ny=4, nz=4, ntimes=20, reneigh_every=10,
                        kernel="ilist")
    p = mk()
    if p.xprd / ndev < p.cutneigh:
        pytest.skip("slab under cutoff")
    dom = ClusterDomainSimulation(mk(), ndev=ndev)
    assert dom._ilist
    out = dom.run()
    assert int(out.nlocal.sum()) == dom.natoms
    out_s = ClusterSimulation(mk()).run()
    np.testing.assert_allclose(out.temps, out_s.temps, rtol=1e-6)


def test_domain2d_rowlist_matches_single_device():
    """2-D pencil engine on the rowlist fast path vs the single-chip
    rowlist engine."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain2d import Domain2DSimulation

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=8, ny=8, nz=4, ntimes=20, reneigh_every=10,
                        kernel="rowlist")
    p = mk()
    if p.xprd / 2 < p.cutneigh or p.yprd / 2 < p.cutneigh:
        pytest.skip("pencil under cutoff")
    out_single = Simulation(mk()).run()
    dom = Domain2DSimulation(mk(), px=2, py=2)
    out = dom.run()
    np.testing.assert_allclose(
        out.temps, out_single.temps, rtol=1e-6, atol=1e-10
    )


def test_domain3d_rowlist_matches_single_device():
    """3-D brick engine on the rowlist fast path vs the single-chip
    rowlist engine (2x2x2 mesh)."""
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain3d import Domain3DSimulation

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10,
                        kernel="rowlist")
    p = mk()
    if min(p.xprd, p.yprd, p.zprd) / 2 < p.cutneigh:
        pytest.skip("brick under cutoff")
    out_single = Simulation(mk()).run()
    dom = Domain3DSimulation(mk(), px=2, py=2, pz=2)
    out = dom.run()
    np.testing.assert_allclose(
        out.temps, out_single.temps, rtol=1e-6, atol=1e-10
    )


def test_domain_run_chunked_overflow_replay():
    """Mid-run capacity overflow in the DOMAIN engine must grow and
    REPLAY the failed chunk from the last good boundary — never restart
    from t=0 (the domain twin of test_run_chunked_overflow_recovery;
    VERDICT r4 weak #7). rcap is pinned at the cold-lattice maximum so
    the hot melt forces an overflow at a later rebuild."""
    from jax.sharding import PartitionSpec as P

    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.parallel.verlet_domain import DomainSimulation

    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mk = lambda: Params(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10,
                        kernel="rowlist", temp=9.0)
    # oracle = the SAME engine uninterrupted (capacity padding is exact
    # zeros, so replay-under-grown-caps must reproduce it near-bitwise);
    # the single-chip cross-check runs at a chaos-widened tolerance
    oracle = DomainSimulation(mk(), ndev=ndev).run()
    oracle_s = Simulation(mk()).run()

    dom = DomainSimulation(mk(), ndev=ndev)
    dom._calibrated = True  # manual pinning replaces the melted probe
    spec = P("x")

    def obs(x, v, n):
        out = dom._reneighbor_dev(x[0], v[0], n[0], with_stats=True)
        return out[6].numneigh[None]

    nr = jax.jit(jax.shard_map(
        obs, mesh=dom.mesh, in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False,
    ))(dom.x0, dom.v0, dom.n0)
    cold = int(np.asarray(nr).max())
    dom.rcap = (cold + 7) // 8 * 8  # fits t=0, overflows once melted
    rcap0 = dom.rcap
    dom._fix_row_layout()
    dom._init_host_state(*dom._xv_init)

    out = dom.run_chunked(10, 3)
    assert dom.rcap > rcap0, "recovery never fired: overflow not forced"
    np.testing.assert_allclose(out.temps, oracle.temps, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(out.temps, oracle_s.temps, rtol=1e-4)
