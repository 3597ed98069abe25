"""Binary checkpoint / resume of simulation state.

The reference has no mid-run checkpointing (SURVEY §5.4); its closest
facility is the `-w` restartable `.in` atom file (atom.c:564-588). This
module adds proper save/restore (positions + velocities + step + params
fingerprint) via npz — cheap because state lives in a handful of dense
arrays.
"""

from __future__ import annotations

import json

import numpy as np


def save_checkpoint(path: str, sim, state, step: int) -> None:
    """Works for both engines (flat or cluster layout)."""
    if hasattr(state, "clusters"):  # cluster engine
        x_flat, v_flat = sim._flatten(state)
        x = np.asarray(x_flat[: sim.nlocal])
        v = np.asarray(v_flat[: sim.nlocal])
    else:
        x = np.asarray(state.x[: sim.nlocal])
        v = np.asarray(state.v[: sim.nlocal])
    meta = dict(
        step=step,
        natoms=sim.natoms,
        scheme=sim.params.scheme,
        force_field=sim.params.force_field,
        ntypes=getattr(sim.params, "ntypes", 1),
        eam_file=getattr(sim.params, "eam_file", ""),
        xprd=sim.params.xprd,
        yprd=sim.params.yprd,
        zprd=sim.params.zprd,
    )
    # atom types: both engines carry per-atom type assignments; a resume
    # of a multi-type or EAM run must not silently lose them
    if hasattr(state, "clusters"):
        types = sim._types0[: sim.nlocal]
    else:
        types = np.asarray(state.types[: sim.nlocal])
    np.savez(path, x=x, v=v, types=types, meta=json.dumps(meta))


def load_checkpoint(path: str):
    """Returns (x, v, types, meta). Feed x/v/types into
    Simulation(params, x=x, v=v, types=types) to resume (params must
    re-supply eam_file per meta for EAM runs — spline tables are
    rebuilt from the funcfl file, not serialized)."""
    d = np.load(path, allow_pickle=False)
    meta = json.loads(str(d["meta"]))
    types = d["types"] if "types" in d.files else None
    return d["x"], d["v"], types, meta
