"""Runtime backend setup: the one place that looks at the platform
(which force kernel each engine runs, and whether a GPU kernel may run
in the Pallas interpreter), and the persistent compile cache.

Kernel names (``Params.kernel``; "auto" resolves here):

- cluster scheme: ``ilist_pl`` (exact per-unit lists + the Pallas/Triton
  GPU kernel), ``ilist`` (same lists, fused-XLA twin), ``xla``
  (group-shared lists; also the Newton half-list path);
- verlet scheme: ``rowlist_pl`` (packed 16-atom-row lists + the same GPU
  kernel), ``rowlist`` (same lists, fused-XLA twin), ``xla`` (planar
  per-atom lists; also half lists, type tables and EAM).

The GPU kernel is single-type, full-list LJ only. On a CPU it runs only
when a test asks for the interpreter explicitly; ``auto`` never picks it
there.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple, Optional

import jax

from mdbench_tpu.config import FF_EAM, FF_LJ

# fixed in-repo default: the cache path is part of the cache key, so a
# path that moved between runs would never hit
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

GPU_KERNELS = ("ilist_pl", "rowlist_pl")
SCHEME_KERNELS = {
    "cluster": ("auto", "ilist_pl", "ilist", "xla"),
    "verlet": ("auto", "rowlist_pl", "rowlist", "xla"),
}


class KernelChoice(NamedTuple):
    kernel: str  # a concrete name from SCHEME_KERNELS (never "auto")
    interpret: bool  # run the Pallas kernel in the interpreter (CPU tests)


def platform() -> str:
    """Platform of the default device ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def resolve_kernel(
    scheme: str,
    precision: str,
    kernel: str = "auto",
    *,
    force_field: int = FF_LJ,
    half: bool = False,
    typed: bool = False,
    interpret: bool = False,
    platform_name: Optional[str] = None,
) -> KernelChoice:
    """Map (platform, scheme, precision, force field, half, typed,
    requested kernel) to the kernel an engine runs.

    ``interpret=True`` lets a GPU kernel run in the Pallas interpreter
    on a CPU (tests only). A GPU kernel requested on a CPU without it,
    or for a case it does not cover, is an error."""
    if scheme not in SCHEME_KERNELS:
        raise ValueError(f"unknown scheme {scheme!r}")
    if kernel not in SCHEME_KERNELS[scheme]:
        raise ValueError(
            f"kernel {kernel!r} is not a {scheme}-scheme kernel "
            f"(one of {', '.join(SCHEME_KERNELS[scheme])})"
        )
    if precision not in ("sp", "dp"):
        raise ValueError(f"precision must be sp|dp, got {precision!r}")
    plat = platform() if platform_name is None else platform_name
    on_gpu = plat == "gpu"
    if interpret and on_gpu:
        raise ValueError("interpret=True is for CPU tests only")
    covered = force_field == FF_LJ and not half and not typed

    if kernel in GPU_KERNELS:
        if not covered:
            raise ValueError(
                f"kernel {kernel!r} is single-type full-list LJ only"
            )
        if not on_gpu and not interpret:
            raise ValueError(
                f"kernel {kernel!r} needs a GPU (found {plat!r}); pass "
                "interpret=True to run it in the Pallas interpreter"
            )
        return KernelChoice(kernel, not on_gpu)

    if scheme == "cluster":
        if force_field == FF_EAM and (half or kernel == "xla"):
            raise ValueError(
                "cluster-scheme EAM runs on full exact lists only "
                "(kernel=auto|ilist)"
            )
        if half:
            return KernelChoice("xla", False)
        if kernel == "auto":
            kernel = "ilist_pl" if on_gpu and covered else "ilist"
        return KernelChoice(kernel, False)

    # verlet: the row-list layout is single-type full-list LJ only
    if kernel == "auto":
        kernel = "rowlist_pl" if on_gpu and covered else "xla"
    elif kernel == "rowlist" and not covered:
        kernel = "xla"
    return KernelChoice(kernel, False)


def resolve_eam_eval(eam_eval: str, precision: str,
                     platform_name: Optional[str] = None) -> str:
    """EAM per-pair evaluation: "auto" = the gather-free polynomial form
    for SP on an accelerator, the reference spline otherwise."""
    if eam_eval != "auto":
        return eam_eval
    plat = platform() if platform_name is None else platform_name
    return "poly" if plat != "cpu" and precision == "sp" else "spline"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads
    it itself and nothing else is set here. Otherwise the cache goes to
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
