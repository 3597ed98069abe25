"""Cluster-scheme EAM: parity vs the verlet engine (same polynomial
evaluation, different data structure — any disagreement is a list or
summation bug, so the DP tolerance is machine-epsilon-tight). The reference's
clusterpair EAM is a dead stub (force_eam.c:20-37); the verlet spline
path remains the reference-parity oracle (test_golden.py)."""

import numpy as np
import pytest

from mdbench_tpu.config import FF_EAM, Params
from mdbench_tpu.engine import Simulation
from mdbench_tpu.engine_cluster import ClusterSimulation

pytestmark = pytest.mark.slow  # engine-level: minutes of XLA:CPU compile on 1 vCPU

EAM_FILE = "/root/reference/data/Cu_u3.eam"
KW = dict(nx=3, ny=3, nz=3, force_field=FF_EAM, eam_file=EAM_FILE,
          ntimes=10, reneigh_every=5)


def _temps(sim):
    out = sim.run()
    assert not bool(np.any(np.asarray(out.state.overflow)))
    return np.asarray(out.temps)


def test_cluster_eam_matches_verlet_poly():
    tv = _temps(Simulation(Params(scheme="verlet", eam_eval="poly", **KW)))
    tc = _temps(ClusterSimulation(Params(scheme="cluster", **KW)))
    np.testing.assert_allclose(tc, tv, rtol=1e-12)


def test_cluster_eam_rejects_unsupported_axes():
    with pytest.raises(ValueError):
        ClusterSimulation(Params(scheme="cluster", half_neigh=1, **KW))
    with pytest.raises(ValueError):
        ClusterSimulation(Params(scheme="cluster", kernel="xla", **KW))


def test_cluster_domain_eam_matches_single_chip():
    """EAM over the cluster domain engine: the mid-force fp refresh
    composes the local border gather with an x-border ppermute over
    the mesh. Trajectory parity vs the single-chip cluster engine
    across rebuilds (slabs need xprd >= 2*cutneigh: nx=8 at the EAM
    lattice constant)."""
    import jax

    from mdbench_tpu.parallel.cluster_domain import ClusterDomainSimulation

    ndev = 2
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    kw = dict(KW, nx=8, ny=3, nz=3)
    ts = _temps(ClusterSimulation(Params(scheme="cluster", **kw)))
    dom = ClusterDomainSimulation(Params(scheme="cluster", **kw), ndev=ndev)
    assert dom.eam_poly is not None
    out = dom.run()
    assert not bool(np.any(out.overflow))
    np.testing.assert_allclose(
        np.asarray(out.temps), ts, rtol=1e-10
    )


@pytest.mark.slow
def test_cluster_eam_longer_run_tracks_verlet():
    kw = dict(KW, nx=4, ny=4, nz=4, ntimes=30, reneigh_every=10)
    tv = _temps(Simulation(Params(scheme="verlet", eam_eval="poly", **kw)))
    tc = _temps(ClusterSimulation(Params(scheme="cluster", **kw)))
    np.testing.assert_allclose(tc, tv, rtol=1e-10)
