"""EAM polynomial fast axis (eam_eval="poly"): fit accuracy vs the
reference spline, force-field equivalence, and trajectory agreement
with the spline path (the gather-free per-pair evaluation is the SP
accelerator axis; the spline path stays the DP parity oracle)."""

import numpy as np
import pytest

from mdbench_tpu.config import FF_EAM, Params
from mdbench_tpu.engine import Simulation
from mdbench_tpu.models.eam_tables import (
    fit_eam_poly,
    load_eam,
    spline_eval_np,
)

EAM_FILES = [
    "/root/reference/data/Cu_u3.eam",
    "/root/reference/data/Cu_u6.eam",
]


@pytest.mark.parametrize("eam_file", EAM_FILES)
def test_poly_fit_accuracy(eam_file):
    """The deg-16 power-basis fit reproduces the per-pair spline
    functions to ~1e-5 of each function's max over the physical
    window — even when evaluated in f32 (the SP fast path)."""
    t = load_eam(eam_file)
    poly = fit_eam_poly(t)
    # ~7e-5 floor: the spline's own inter-knot wiggle in g1 = rhor'/r
    assert poly.max_rel_err < 1e-4

    r = np.linspace(poly.lo + 0.01, poly.cut - 1e-9, 50001)
    tt = ((r - poly.mid) * poly.iscale).astype(np.float32)
    rho_v, rho_d = spline_eval_np(t.rhor_spline, r, t.rdr, t.nr)
    z2_v, z2_d = spline_eval_np(t.z2r_spline, r, t.rdr, t.nr)
    exact = {
        "dens": rho_v,
        "g1": rho_d / r,
        "g2": (z2_d / r - z2_v / (r * r)) / r,
    }
    for name, y in exact.items():
        pw = getattr(poly, name)
        acc = np.full_like(tt, np.float32(pw[-1]))
        for c in pw[-2::-1]:
            acc = acc * tt + np.float32(c)
        err = np.max(np.abs(acc.astype(np.float64) - y)) / np.max(np.abs(y))
        assert err < 2e-4, (name, err)


@pytest.mark.slow  # engine compile on 1-vCPU CI
def test_poly_first_force_matches_spline_path():
    """Forces from the poly path agree with the spline path to the fit
    tolerance on the SAME (perturbed) positions. A perfect FCC lattice
    has zero net forces by symmetry, so a deterministic thermal-scale
    displacement makes the comparison meaningful."""
    f = {}
    for ev in ("spline", "poly"):
        p = Params(nx=3, ny=3, nz=3, force_field=FF_EAM,
                   eam_file=EAM_FILES[0], eam_eval=ev)
        sim = Simulation(p)
        rng = np.random.default_rng(7)
        pert = 0.05 * rng.standard_normal((sim.nlocal, 3))
        sim.x0 = sim.x0.at[: sim.nlocal].add(pert)
        f[ev] = sim.first_force()
    scale = np.abs(f["spline"]).max()
    assert scale > 0.1  # perturbed lattice has real restoring forces
    # ~1e-3 floor: per-pair fit residuals (the spline's inter-knot
    # wiggle that the global fit smooths through) summed over ~36
    # neighbors; the trajectory test below bounds the physics impact
    assert np.max(np.abs(f["spline"] - f["poly"])) / scale < 2e-3


@pytest.mark.slow
def test_poly_trajectory_tracks_spline():
    """30-step Cu trajectory: temperature trace from the poly path
    stays within SP-level drift of the spline path."""
    temps = {}
    for ev in ("spline", "poly"):
        p = Params(nx=4, ny=4, nz=4, force_field=FF_EAM,
                   eam_file=EAM_FILES[0], ntimes=30, reneigh_every=10,
                   eam_eval=ev)
        out = Simulation(p).run()
        assert not bool(out.state.overflow)
        temps[ev] = np.asarray(out.temps)
    rel = np.abs(temps["poly"] - temps["spline"]) / np.abs(temps["spline"])
    assert rel.max() < 1e-3, rel.max()
