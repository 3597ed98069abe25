"""Exact per-i-cluster list path (kernel="ilist", the XLA twin of the
GPU kernel and the CPU "auto" default). Parity against the group-list XLA oracle, the exact
prune's correctness guarantees, capacity calibration/growth, and the
multi-type axis."""

import numpy as np
import pytest

from mdbench_tpu.config import Params
from mdbench_tpu.engine_cluster import GROUP, ClusterSimulation
from mdbench_tpu.ops.cluster import derive_ilists

pytestmark = pytest.mark.slow  # engine-level: minutes of XLA:CPU compile on 1 vCPU

def _sims(half=0, **kw):
    p1 = Params(precision="dp", kernel="ilist", half_neigh=half, **kw)
    p2 = Params(precision="dp", kernel="xla", half_neigh=half, **kw)
    return ClusterSimulation(p1), ClusterSimulation(p2)


def test_ilist_forces_match_group_oracle():
    s1, s2 = _sims(nx=6, ny=6, nz=6)
    f1, f2 = s1.first_force_atoms(), s2.first_force_atoms()
    assert np.abs(f1 - f2).max() < 1e-10


def test_ilist_trajectory_parity():
    # skin=1.0 so no pair can cross cutforce between rebuilds (default
    # skin 0.3 admits rare tail events that the exact unit lists and
    # the group-windowed lists legitimately resolve differently)
    s1, s2 = _sims(nx=5, ny=5, nz=5, ntimes=60, skin=1.0)
    r1, r2 = s1.run(), s2.run()
    assert np.abs(r1.temps - r2.temps).max() < 1e-8


def test_ilist_counts_match_exact_reference_count():
    """nji must equal the exact number of j16 clusters with any atom
    within cutneigh of any atom of the i-UNIT (= `share` consecutive
    i-clusters; the reference's atomDistanceInRange semantics,
    neighbor.c:262-436)."""
    p = Params(precision="dp", kernel="ilist", nx=4, ny=4, nz=4)
    sim = ClusterSimulation(p)
    st = sim.initial_state()
    cl = st.clusters
    share = sim.ishare
    xc, yc, zc = (np.asarray(a) for a in (cl.xc, cl.yc, cl.zc))
    cjn = xc.shape[0] // 2
    x16 = np.stack([xc.reshape(cjn, 16), yc.reshape(cjn, 16),
                    zc.reshape(cjn, 16)], axis=2)  # (cjn, 16, 3)
    nji = np.asarray(st.pairs.nji)
    ijl = np.asarray(st.pairs.ijlist)
    n_units = ijl.shape[0]
    assert n_units * share == sim.n_clusters_pad
    cut2 = p.cutneigh**2
    rng = np.random.default_rng(7)
    for iu in rng.choice(n_units, size=24, replace=False):
        ics = range(iu * share, (iu + 1) * share)
        xi = np.concatenate(
            [np.stack([xc[ic], yc[ic], zc[ic]], axis=1) for ic in ics]
        )  # (share*8, 3)
        real = np.abs(xi[:, 0]) < 1e29
        if not real.any():
            assert nji[iu] == 0
            continue
        # brute force: every j16 cluster within cutneigh of this unit
        d = xi[real][:, None, None, :] - x16[None]  # (m, cjn, 16, 3)
        rsq = (d * d).sum(3)
        inrange = (rsq.min(axis=(0, 2)) <= cut2)
        # the derive only sees candidates from the group list; the group
        # list is itself complete, so the exact set must match
        expect = set(np.nonzero(inrange)[0].tolist())
        # exclude all-sentinel j16 clusters (coords ~1e30 -> not in range)
        got = set(ijl[iu, : nji[iu]].tolist())
        assert got == expect, (iu, got ^ expect)


def test_ilist_entries_sentinel_padded():
    p = Params(precision="dp", kernel="ilist", nx=4, ny=4, nz=4)
    sim = ClusterSimulation(p)
    st = sim.initial_state()
    ijl = np.asarray(st.pairs.ijlist)
    nji = np.asarray(st.pairs.nji)
    cjn = np.asarray(st.clusters.xc).shape[0] // 2
    sentinel16 = cjn - 1
    icap = ijl.shape[1]
    for ic in range(0, ijl.shape[0], 97):
        assert (ijl[ic, nji[ic]:] == sentinel16).all()
    assert nji.max() <= icap


def test_ilist_multitype_parity():
    rng = np.random.default_rng(3)
    p = Params(precision="dp", nx=4, ny=4, nz=4, ntypes=2)
    n = p.natoms_expected
    types = rng.integers(0, 2, n).astype(np.int32)
    eps = np.array([[1.0, 0.7], [0.7, 0.5]])
    sig6 = np.array([[1.0, 0.8], [0.8, 0.6]])
    cutsq = np.full((2, 2), p.cutforce**2)
    tables = (eps, sig6, cutsq)
    out = {}
    for kern in ("ilist", "xla"):
        pk = Params(precision="dp", nx=4, ny=4, nz=4, ntypes=2,
                    kernel=kern)
        sim = ClusterSimulation(pk, types=types, tables=tables)
        out[kern] = sim.first_force_atoms()
    assert np.abs(out["ilist"] - out["xla"]).max() < 1e-10


def test_ilist_capacity_growth_on_overflow():
    p = Params(precision="dp", kernel="ilist", nx=4, ny=4, nz=4, ntimes=4)
    sim = ClusterSimulation(p)
    sim.icap = 8  # far too small — run() must grow and retry
    r = sim.run()
    assert sim.icap > 8
    assert np.isfinite(r.temps).all()


def test_ilist_prune_is_trajectory_invariant():
    # skin=1.0: see test_ilist_trajectory_parity — the prune re-derives
    # lists from CURRENT coordinates, so with the default skin a pair
    # drifting into cutneigh mid-interval is (correctly) added by the
    # prune but absent without it; a wide skin makes that irrelevant to
    # forces and restores exact invariance
    kw = dict(nx=5, ny=5, nz=5, ntimes=40, reneigh_every=20, skin=1.0)
    p1 = Params(precision="dp", kernel="ilist", prune_every=7, **kw)
    p2 = Params(precision="dp", kernel="ilist", prune_every=0, **kw)
    r1 = ClusterSimulation(p1).run()
    r2 = ClusterSimulation(p2).run()
    assert np.abs(r1.temps - r2.temps).max() < 1e-10


def test_auto_resolves_to_ilist():
    p = Params(precision="dp", nx=4, ny=4, nz=4)  # kernel="auto"
    sim = ClusterSimulation(p)
    st = sim.initial_state()
    assert st.pairs.ijlist is not None
    assert st.pairs.nji is not None

