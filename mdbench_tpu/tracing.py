"""Tracing / profiling hooks (reference: src/verletlist/tracing.{c,h},
likwid-marker.h — SURVEY §5.1).

Three mechanisms, mapped onto JAX:

- LIKWID marker regions -> `region(name)`: jax.profiler.TraceAnnotation
  scopes that show up as named spans in an xprof/tensorboard trace.
- Whole-run hardware traces -> `profile(logdir)`: jax.profiler trace
  context (open with xprof / tensorboard-profile).
- MEM_TRACER / INDEX_TRACER -> `dump_index_trace`: writes the neighbor
  indices and per-row SIMD-chunk j-distances for one timestep to
  `index_tracer_<step>.out` in the reference's spirit (tracing.h:47-123)
  — an off-hot-path host dump for gather/cache studies.
"""

from __future__ import annotations

import contextlib

import numpy as np


def region(name: str):
    """Named profiling span (LIKWID_MARKER_START/STOP analogue)."""
    import jax.profiler

    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a device trace for xprof (jax.profiler wrapper)."""
    import jax.profiler

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def dump_mem_trace(path_prefix: str, neighbors, numneigh, step: int,
                   nlocal: int | None = None, float_size: int = 4) -> str:
    """MEM_TRACER-equivalent address-stream dump (reference
    tracing.h:24-45): every array element the force kernel touches, one
    record per line, as byte addresses in the framework's planar SoA
    layout (x plane base 0, f plane follows; neighbor-row int32 stream
    last). Consumed by cache simulators exactly like the reference's
    mem_tracer_<step>.out. Host-side, off the hot path."""
    nb = np.asarray(neighbors)
    nn = np.asarray(numneigh)
    n = nb.shape[0] if nlocal is None else nlocal
    nrows = nb.shape[0]
    x_base = 0
    f_base = nrows * 3 * float_size
    nl_base = 2 * nrows * 3 * float_size
    path = f"{path_prefix}mem_tracer_{step}.out"
    from mdbench_tpu.io import native

    if native.write_mem_trace(path, nb, nn, n, nrows, float_size):
        return path
    with open(path, "w") as fp:
        for i in range(n):
            k = int(nn[i])
            # force row read-modify-write + own position read
            fp.write(f"R: {x_base + i * 3 * float_size} {3 * float_size}\n")
            for c in range(k):
                fp.write(
                    "R: %d 4\n" % (nl_base + (i * nb.shape[1] + c) * 4)
                )
                j = int(nb[i, c])
                fp.write(
                    "R: %d %d\n" % (x_base + j * 3 * float_size,
                                    3 * float_size)
                )
            fp.write(f"W: {f_base + i * 3 * float_size} {3 * float_size}\n")
    return path


def dump_index_trace(path_prefix: str, neighbors, numneigh, step: int,
                     vector_width: int = 8) -> str:
    """INDEX_TRACER-style dump (reference tracing.h:47-123): per atom the
    neighbor indices, chunked by the vector width, with min/max distance
    (in index space) per chunk — input for gather-pattern analysis."""
    path = f"{path_prefix}index_tracer_{step}.out"
    nb = np.asarray(neighbors)
    nn = np.asarray(numneigh)
    from mdbench_tpu.io import native

    if native.write_index_trace(path, nb, nn, vector_width):
        return path
    with open(path, "w") as fp:
        for i in range(nb.shape[0]):
            k = int(nn[i])
            fp.write(f"A: {i} {k}\n")
            for c0 in range(0, k, vector_width):
                chunk = nb[i, c0 : min(c0 + vector_width, k)]
                fp.write(
                    "C: %d %d\n" % (int(chunk.min()), int(chunk.max()))
                )
                fp.write("I: " + " ".join(str(int(j)) for j in chunk) + "\n")
    return path
