"""mdbench_tpu — a molecular-dynamics benchmark framework in JAX, run on
an NVIDIA GPU (H100) and tested on the CPU.

A from-scratch rebuild of the capabilities of MD-Bench (the NHR@FAU
short-range MD proxy-app toolbox):

- force/neighbor kernels expressed as XLA programs plus one Pallas
  kernel for the GPU (through Triton, ops/pallas/lj_cluster.py) over
  device-resident, fixed-capacity padded arrays (replacing the
  reference's AVX intrinsics and CUDA kernels); ``backend.py`` picks the
  kernel per platform,
- the whole timestep loop inside one jitted ``lax.scan`` (zero host
  round-trips between reneighbor events),
- multi-device scaling via spatial domain decomposition sharded over a
  ``jax.sharding.Mesh`` with ppermute halo exchange (the reference is
  single-node; see parallel/).

Two neighbor schemes, mirroring the reference's two compile-time trees:

- ``verlet``  — LAMMPS/miniMD-style per-atom Verlet neighbor lists
  (reference: src/verletlist/).
- ``cluster`` — GROMACS MxN cluster-pair lists: 8-atom i-clusters,
  16-atom j-clusters, exact per-unit j-lists (reference:
  src/clusterpair/).

Force fields: Lennard-Jones and EAM (funcfl spline tables), as in the
reference (src/verletlist/force_lj.c, force_eam.c, src/common/eam_utils.c).
"""

__version__ = "0.1.0"

from mdbench_tpu.config import Params, read_parameter_file  # noqa: F401
