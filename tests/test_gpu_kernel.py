"""The GPU exact-list LJ kernel and what surrounds it, on the CPU: the
kernel in the Pallas interpreter against the fused-XLA twin, the verlet
row-list force through it, the kernel resolver's table, the compile-cache
helper, and chip_smoke.py refusing to run without a GPU. One card-only
test compiles the kernel for the GPU (marker `gpu`)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdbench_tpu import backend
from mdbench_tpu.config import FF_EAM, FF_LJ
from mdbench_tpu.ops.pallas.lj_cluster import (
    JB,
    lj_cluster_force_ilist_gpu,
    lj_cluster_force_xla_ilist,
)

REPO = Path(__file__).resolve().parent.parent
CUTSQ = 2.5**2


def _jittered_lattice_clusters(ncl, rng, dtype):
    """(ncl, 8) coordinate planes of a jittered cubic lattice (spacing
    ~1.06, the default density) with the last row pair the sentinel
    j16 cluster, so pair distances and forces are physical."""
    side = int(np.ceil((ncl * 8) ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    pts = g.reshape(-1, 3)[: ncl * 8] * 1.06
    pts = pts + rng.normal(0.0, 0.05, pts.shape)
    pts[-16:] = 1e30
    return [jnp.asarray(pts[:, k].reshape(ncl, 8), dtype) for k in range(3)]


def _lists(nu, icap, cjn, fill, rng):
    """Exact-list tables: nji per unit ("empty" 0, "partial" 1..icap-1,
    "full" icap), real entries distinct j16 ids, sentinel padding."""
    if fill == "empty":
        nji = np.zeros(nu, np.int32)
    elif fill == "full":
        nji = np.full(nu, icap, np.int32)
    else:
        nji = rng.integers(1, icap, nu).astype(np.int32)
    ijl = np.full((nu, icap), cjn - 1, np.int32)
    for u in range(nu):
        ijl[u, : nji[u]] = rng.choice(cjn - 1, nji[u], replace=False)
    return jnp.asarray(ijl), jnp.asarray(nji)


@pytest.fixture
def on_gpu():
    """Skips a card-only test where JAX has no GPU (decided here, at
    run time, never while the module is imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the kernel is compiled, not interpreted")


@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
@pytest.mark.parametrize("share", [1, 2])
def test_ilist_gpu_interpret_matches_xla_twin(share, fill):
    rng = np.random.default_rng(100 * share + len(fill))
    cjn, nu, icap = 40, 24, 2 * JB
    npad = nu * share
    xc, yc, zc = _jittered_lattice_clusters(2 * cjn, rng, jnp.float32)
    ijl, nji = _lists(nu, icap, cjn, fill, rng)
    got = lj_cluster_force_ilist_gpu(
        xc, yc, zc, ijl, nji, npad, CUTSQ, 1.0, 1.0, share=share,
        interpret=True,
    )
    want = lj_cluster_force_xla_ilist(
        xc, yc, zc, ijl, npad, CUTSQ, 1.0, 1.0, share=share
    )
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == (npad, 8) and np.isfinite(g).all()
        if fill == "empty":
            assert not g.any()
        else:
            assert np.abs(w).max() > 1.0  # physical, not cancellation
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * np.abs(w).max()
            )


def test_rowlist_gpu_interpret_matches_planar():
    """The verlet row-list force through the GPU kernel (interpreted)
    equals the planar per-atom kernel: the row lists are a row-granular
    superset of the per-atom lists and the cutoff mask does the rest."""
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine import Simulation
    from mdbench_tpu.models.lattice import create_fcc_lattice

    p = Params(nx=3, ny=3, nz=3)
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0, 0.03, x.shape)
    f_plain = Simulation(
        Params(nx=3, ny=3, nz=3, kernel="xla"), x=x, v=v, adjust=False
    ).first_force()
    f_rows = Simulation(
        Params(nx=3, ny=3, nz=3, kernel="rowlist_pl"), x=x, v=v,
        adjust=False, interpret=True,
    ).first_force()
    np.testing.assert_allclose(f_rows, f_plain, rtol=1e-10, atol=1e-10)


# (platform, scheme, precision, force field, half, typed, requested)
# -> resolved kernel
RESOLVE_TABLE = [
    ("gpu", "cluster", "sp", FF_LJ, False, False, "auto", "ilist_pl"),
    ("gpu", "cluster", "dp", FF_LJ, False, False, "auto", "ilist_pl"),
    ("gpu", "cluster", "sp", FF_LJ, False, True, "auto", "ilist"),
    ("gpu", "cluster", "sp", FF_LJ, True, False, "auto", "xla"),
    ("gpu", "cluster", "sp", FF_EAM, False, False, "auto", "ilist"),
    ("gpu", "cluster", "sp", FF_LJ, False, False, "ilist", "ilist"),
    ("gpu", "cluster", "sp", FF_LJ, False, False, "xla", "xla"),
    ("cpu", "cluster", "sp", FF_LJ, False, False, "auto", "ilist"),
    ("cpu", "cluster", "dp", FF_LJ, True, False, "ilist", "xla"),
    ("cpu", "cluster", "dp", FF_EAM, False, False, "auto", "ilist"),
    ("gpu", "verlet", "sp", FF_LJ, False, False, "auto", "rowlist_pl"),
    ("gpu", "verlet", "dp", FF_LJ, False, False, "auto", "rowlist_pl"),
    ("gpu", "verlet", "sp", FF_LJ, True, False, "auto", "xla"),
    ("gpu", "verlet", "sp", FF_LJ, False, True, "auto", "xla"),
    ("gpu", "verlet", "sp", FF_EAM, False, False, "auto", "xla"),
    ("gpu", "verlet", "sp", FF_LJ, False, False, "rowlist", "rowlist"),
    ("gpu", "verlet", "sp", FF_LJ, True, False, "rowlist", "xla"),
    ("cpu", "verlet", "sp", FF_LJ, False, False, "auto", "xla"),
    ("cpu", "verlet", "dp", FF_LJ, False, False, "rowlist", "rowlist"),
]


@pytest.mark.parametrize(
    "plat,scheme,prec,ff,half,typed,req,want", RESOLVE_TABLE
)
def test_resolve_kernel_table(plat, scheme, prec, ff, half, typed, req,
                              want):
    got = backend.resolve_kernel(
        scheme, prec, req, force_field=ff, half=half, typed=typed,
        platform_name=plat,
    )
    assert got == backend.KernelChoice(want, False)


@pytest.mark.parametrize("scheme,kernel", [("cluster", "ilist_pl"),
                                           ("verlet", "rowlist_pl")])
def test_resolve_gpu_kernel_on_cpu_needs_interpret(scheme, kernel):
    with pytest.raises(ValueError, match="needs a GPU"):
        backend.resolve_kernel(scheme, "sp", kernel, platform_name="cpu")
    got = backend.resolve_kernel(scheme, "sp", kernel, interpret=True,
                                 platform_name="cpu")
    assert got == backend.KernelChoice(kernel, True)
    # and on the GPU the interpreter is refused
    with pytest.raises(ValueError):
        backend.resolve_kernel(scheme, "sp", kernel, interpret=True,
                               platform_name="gpu")


@pytest.mark.parametrize("kwargs", [
    dict(scheme="cluster", kernel="ilist_pl", typed=True),
    dict(scheme="verlet", kernel="rowlist_pl", half=True),
    dict(scheme="cluster", kernel="ilist_pl", force_field=FF_EAM),
    dict(scheme="cluster", kernel="xla", force_field=FF_EAM),
    dict(scheme="cluster", kernel="rowlist"),
    dict(scheme="verlet", kernel="pallas"),
])
def test_resolve_kernel_rejects_unsupported(kwargs):
    scheme = kwargs.pop("scheme")
    kernel = kwargs.pop("kernel")
    with pytest.raises(ValueError):
        backend.resolve_kernel(scheme, "sp", kernel, platform_name="gpu",
                               **kwargs)


def test_engine_refuses_gpu_kernel_on_cpu_without_interpret():
    from mdbench_tpu.config import Params
    from mdbench_tpu.engine_cluster import ClusterSimulation

    with pytest.raises(ValueError, match="needs a GPU"):
        ClusterSimulation(Params(nx=2, ny=2, nz=2, kernel="ilist_pl"))


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.enable_compile_cache() == str(tmp_path)
    # nothing else set: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.gpu
def test_ilist_gpu_compiled_matches_xla_twin(on_gpu):
    rng = np.random.default_rng(7)
    cjn, nu, icap, share = 512, 256, 8 * JB, 2
    xc, yc, zc = _jittered_lattice_clusters(2 * cjn, rng, jnp.float32)
    ijl, nji = _lists(nu, icap, cjn, "partial", rng)
    got = lj_cluster_force_ilist_gpu(
        xc, yc, zc, ijl, nji, nu * share, CUTSQ, 1.0, 1.0, share=share
    )
    want = lj_cluster_force_xla_ilist(
        xc, yc, zc, ijl, nu * share, CUTSQ, 1.0, 1.0, share=share
    )
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
