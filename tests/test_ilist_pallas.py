"""The GPU exact-list kernel (kernel="ilist_pl") run by the engines in
interpret mode, against the XLA twin and the group-list oracle; plus the
share=2 list axis itself."""

import numpy as np
import pytest

from mdbench_tpu.config import Params
from mdbench_tpu.engine_cluster import ClusterSimulation

pytestmark = pytest.mark.slow  # engine-level: minutes of XLA:CPU compile on 1 vCPU


def test_ilist_pallas_forces_match_xla_twin():
    from mdbench_tpu.models.lattice import create_fcc_lattice

    p1 = Params(precision="sp", kernel="ilist_pl", nx=4, ny=4, nz=4)
    p2 = Params(precision="sp", kernel="ilist", nx=4, ny=4, nz=4)
    x, v, _ = create_fcc_lattice(p1)
    # off the perfect lattice so forces are O(1), not cancellation noise
    x = x + np.random.default_rng(5).normal(0, 0.03, x.shape)
    f1 = ClusterSimulation(p1, x=x, v=v, adjust=False,
                           interpret=True).first_force_atoms()
    f2 = ClusterSimulation(p2, x=x, v=v, adjust=False).first_force_atoms()
    # same lists and pair math; only the summation order differs
    np.testing.assert_allclose(f1, f2, rtol=0, atol=1e-5 * np.abs(f2).max())


def test_ilist_pallas_trajectory_vs_group_oracle():
    p1 = Params(precision="sp", kernel="ilist_pl", nx=4, ny=4, nz=4,
                ntimes=20)
    p2 = Params(precision="sp", kernel="xla", nx=4, ny=4, nz=4, ntimes=20)
    r1 = ClusterSimulation(p1, interpret=True).run()
    r2 = ClusterSimulation(p2).run()
    assert np.abs(np.asarray(r1.temps) - np.asarray(r2.temps)).max() < 2e-3


def test_share2_lists_halve_rows():
    p = Params(precision="dp", kernel="ilist", nx=5, ny=5, nz=5)
    sim = ClusterSimulation(p)
    assert sim.ishare == 2
    st = sim.initial_state()
    nu = np.asarray(st.pairs.ijlist).shape[0]
    assert nu * 2 == sim.n_clusters_pad
    # every i-cluster's exact neighbors must be covered by its unit list
    nji = np.asarray(st.pairs.nji)
    assert (nji > 0).any()
