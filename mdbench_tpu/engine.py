"""The simulation engine: setup, the jitted timestep loop, reneighboring.

Driver-loop parity (reference: src/verletlist/main.c:129-344):

  setup -> thermo(0) -> force(step 0) ->
  loop n = 0..ntimes-1:
      initialIntegrate
      (n+1) % reneigh_every == 0 ? reneighbour : updatePbc
      computeForce
      finalIntegrate
      thermo at (n+1) % nstat == 0
  -> thermo(ntimes)

Device structure: the WHOLE loop — including reneighboring — runs
inside one jitted program as nested scans (outer over reneighbor
intervals, inner over plain steps; no lax.cond in the hot loop).
Reneighboring wraps atoms, rebuilds the halo, re-bins, and rebuilds the
neighbor list entirely on device. There are
zero host round-trips inside a run; capacity-overflow flags accumulate
in the carry and are checked once at the end (on overflow the host grows
capacities and re-runs — the reference's RESIZE/realloc loops, amortized
to whole-run granularity).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mdbench_tpu.backend import resolve_kernel
from mdbench_tpu.config import FF_EAM, FF_LJ, Params
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import lj as lj_ops
from mdbench_tpu.ops.cells import CellGrid, build_cells, make_cell_grid, sort_atoms_host
from mdbench_tpu.ops.integrate import (
    final_integrate,
    initial_integrate,
    wrap_into_box,
)
from mdbench_tpu.ops.pbc import ghost_types, setup_pbc, update_pbc
from mdbench_tpu.ops.verlet import (
    build_neighbors,
    compute_force_lj_rowlist,
    derive_rowlists_from_cells,
    derive_rowlists_from_ranges,
)
from mdbench_tpu.state import SENTINEL_COORD, Halo, NeighborList
from mdbench_tpu.thermo import (
    ThermoScales,
    adjust_thermo,
    adjusted_dtforce,
    compute_thermo,
    setup_thermo,
)


class Capacities(NamedTuple):
    """Padded array sizes; growing any of these forces a retrace
    (the device analogue of the reference's realloc events)."""

    nlocal_pad: int
    ghost: int
    maxneighs: int
    cell: int


class StepState(NamedTuple):
    """Carry of the step scan."""

    x: jnp.ndarray
    v: jnp.ndarray
    f: jnp.ndarray
    types: jnp.ndarray
    halo: Halo
    nlist: NeighborList
    overflow: jnp.ndarray  # () bool, accumulated


class RunResult(NamedTuple):
    temps: np.ndarray  # (ntimes,) temperature after each step
    press: np.ndarray  # (ntimes,)
    state: StepState
    total_time: float
    force_time: float
    neigh_time: float
    compile_time: float = float("nan")  # seconds to compile the run


def _estimate_maxneighs(params: Params) -> int:
    """Density-based neighbor estimate: atoms in the cutneigh sphere,
    with headroom; at least the reference default of 100
    (neighbor.c:59)."""
    vol = 4.0 / 3.0 * np.pi * params.cutneigh**3
    est = int(np.ceil(vol * params.rho * 1.25))
    if params.half_neigh:
        est = int(np.ceil(est * 0.6))
    return max(params.maxneighs, ((est + 7) // 8) * 8)


def _estimate_ghost_capacity(params: Params, nlocal: int) -> int:
    c = params.cutneigh
    fx = 1.0 + 2.0 * c / params.xprd
    fy = 1.0 + 2.0 * c / params.yprd
    fz = 1.0 + 2.0 * c / params.zprd
    est = int(np.ceil(nlocal * (fx * fy * fz - 1.0) * 1.5)) + 64
    return ((est + 7) // 8) * 8


class Simulation:
    """End-to-end MD simulation on one chip (multi-chip: parallel/)."""

    def __init__(
        self,
        params: Params,
        x: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        types: Optional[np.ndarray] = None,
        adjust: Optional[bool] = None,
        interpret: bool = False,  # GPU kernel in the interpreter (tests)
    ):
        self.params = params
        self.eam_tables = None
        self.eam_poly = None
        if params.force_field == FF_EAM:
            # EAM file load overrides several params BEFORE the lattice is
            # generated (reference: setup() calls initEam first, main.c:38)
            from mdbench_tpu.models.eam_tables import (
                apply_eam_overrides,
                load_eam,
            )

            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            self.eam_tables = load_eam(params.eam_file)
            apply_eam_overrides(params, self.eam_tables)
        if x is None and params.input_file:
            # file-provided systems are NOT thermo-adjusted
            # (reference: setup() main.c:60-62)
            from mdbench_tpu.io.readers import read_atom

            r = read_atom(params)
            x, v, types = r.x, r.v, r.types
            if adjust is None:
                adjust = False
        if x is None:
            x, v, types = create_fcc_lattice(params)
            if adjust is None:
                adjust = True  # reference adjusts only generated systems
        self.natoms = x.shape[0]
        self.nlocal = x.shape[0]
        self.scales: ThermoScales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        if adjust:
            v = adjust_thermo(params, self.scales, v, self.natoms)
        if types is None:
            types = np.zeros(self.nlocal, np.int32)

        prd = np.array([params.xprd, params.yprd, params.zprd])
        self.grid: CellGrid = make_cell_grid(
            prd, params.cutneigh, params.rho, 0
        )
        if params.sort_atoms:
            # sort by the WRAPPED position (key only, coords untouched):
            # _reneighbor wraps before building lists, so an out-of-box
            # atom (file-read or perturbed systems) that wraps after a
            # raw-coordinate sort would violate the bin-sortedness
            # invariant the range rowbuild relies on
            xw = np.where(x < 0.0, x + prd, x)
            xw = np.where(xw >= prd, xw - prd, xw)
            perm = sort_atoms_host(self.grid, xw)
            x, v, types = x[perm], v[perm], types[perm]
        self._x0, self._v0, self._types0 = x, v, types

        # fast path for the verlet scheme: packed 16-atom-row lists +
        # the exact-list kernels (rowlist_pl: the GPU kernel, rowlist:
        # the fused-XLA twin). Single-type full-neighbor LJ only — half
        # lists, type tables and EAM stay on the planar kernels.
        self._kmode, self.interpret = resolve_kernel(
            "verlet", params.precision, params.kernel,
            force_field=params.force_field, half=bool(params.half_neigh),
            typed=params.ntypes > 1, interpret=interpret,
        )
        self._rowlist = self._kmode in ("rowlist", "rowlist_pl")
        self.rcap = 64  # row-list capacity; grown on overflow
        self.ccap = 128  # pre-prune row-candidate capacity
        self.ucl = 4  # distinct xy COLUMNS per unit (grown on overflow)
        self.zw = 4  # z-run width (covers a unit column's zspan + 2)
        self.ubr = 8  # distinct 16-rows per cell
        self.ukr = 40  # candidate row-RANGES per unit (ranges build)
        # range-based rebuild (derive_rowlists_from_ranges) requires the
        # sortedness invariants: locals re-sorted at EVERY reneighbor
        # (sort_atoms) and cell-sorted ghosts — both true exactly when
        # the rowlist path runs with sort_atoms on
        self._rowbuild_ranges = self._rowlist and params.sort_atoms
        self._force_reps = 1  # cli --timers diff sets 2 (in-loop timing)
        self._rcap_calibrated = False
        self._melt_calibrated = False
        pad_unit = 256
        self.caps = Capacities(
            nlocal_pad=((self.nlocal + pad_unit - 1) // pad_unit)
            * pad_unit,
            ghost=_estimate_ghost_capacity(params, self.nlocal),
            maxneighs=_estimate_maxneighs(params),
            cell=self.grid.capacity,
        )
        self._build_device_state()

    # -- state assembly ---------------------------------------------------

    def _build_device_state(self):
        p, caps = self.params, self.caps
        dtype = p.dtype
        self.grid = self.grid._replace(capacity=caps.cell)
        # row count: locals, ghost slots, then >= 16 sentinel rows
        # rounded so nrows % 16 == 0 — the last 16-atom row is pure
        # sentinel, the padding target of the row lists (and row
        # nrows-1 stays the per-atom lists' sentinel row)
        nrows = (caps.nlocal_pad + caps.ghost + 16 + 15) // 16 * 16
        xp = np.full((nrows, 3), SENTINEL_COORD, np.float64)
        xp[: self.nlocal] = self._x0
        vp = np.zeros((caps.nlocal_pad, 3), np.float64)
        vp[: self.nlocal] = self._v0
        tp = np.zeros(nrows, np.int32)
        tp[: self.nlocal] = self._types0

        self.x0 = jnp.asarray(xp, dtype)
        self.v0 = jnp.asarray(vp, dtype)
        self.types0 = jnp.asarray(tp)

        nt = p.ntypes
        if nt == 1:
            self.tables = None
            self.cutforcesq = p.cutforce**2
            self.cutneighsq = p.cutneigh**2
        else:
            from mdbench_tpu.state import TypeTables

            self.tables = TypeTables(
                types=self.types0,
                epsilon=jnp.full((nt, nt), p.epsilon, dtype),
                sigma6=jnp.full((nt, nt), p.sigma6, dtype),
                cutforcesq=jnp.full((nt, nt), p.cutforce**2, dtype),
                cutneighsq=jnp.full((nt, nt), p.cutneigh**2, dtype),
            )
            self.cutforcesq = self.tables.cutforcesq
            self.cutneighsq = self.tables.cutneighsq
        self.prd = np.array([p.xprd, p.yprd, p.zprd])

        if self.eam_tables is not None:
            from mdbench_tpu.ops.eam import EamDevice, use_poly_eval

            t = self.eam_tables
            self.eam_dev = EamDevice.from_tables(t, dtype)
            # gather-free per-pair fast axis (eam_eval="poly"; "auto" =
            # poly on accelerator SP runs — the spline stays the DP
            # parity axis)
            if use_poly_eval(p):
                from mdbench_tpu.models.eam_tables import fit_eam_poly

                self.eam_poly = fit_eam_poly(t)

    # -- device-side phases ------------------------------------------------

    def _reneighbor(self, x, v, types):
        """Wrap atoms, rebuild halo + ghosts + cells + neighbor list.
        (reference reneighbour(), main.c:76-95). Pure function of state.
        Named scope = LIKWID "reneighbour" region in xprof traces."""
        with jax.named_scope("reneighbor"):
            return self._reneighbor_inner(x, v, types)

    def _reneighbor_inner(self, x, v, types):
        p, caps = self.params, self.caps
        x = wrap_into_box(x, self.prd, self.nlocal)
        halo = setup_pbc(
            x, self.nlocal, caps.nlocal_pad, caps.ghost, self.prd,
            (p.pbc_x, p.pbc_y, p.pbc_z), p.cutneigh,
            # rowlist path: cell-sorted ghosts keep ghost 16-rows
            # spatially compact (halves the per-unit row unions);
            # off elsewhere so DP golden trajectories keep the
            # reference's ghost summation order bit-for-bit
            sort_grid=self.grid if self._rowlist else None,
        )
        types = ghost_types(types, halo, caps.nlocal_pad)
        x = update_pbc(x, halo, caps.nlocal_pad)
        if self._rowlist:
            # rowlist fast path: unit-granular list build straight from
            # the cell table — the per-atom verlet lists (16x the
            # gathered rows and sort rows) are never built. Per-atom
            # lists for stats/tracing
            # come from per_atom_lists() on demand.
            if self._rowbuild_ranges:
                # sort-free range build: needs bin-sorted locals
                # (resort rides every reneighbor) + cell-sorted ghosts;
                # no atom cell table at all
                rows, numrows, ncmax, rovf = derive_rowlists_from_ranges(
                    self.grid, x, self.nlocal, caps.nlocal_pad,
                    caps.ghost, self.rcap, p.cutneigh,
                    ucol=self.ucl, kcap=self.ukr, ccap=self.ccap,
                )
            else:
                cl = build_cells(self.grid, x)
                rows, numrows, ncmax, rovf = derive_rowlists_from_cells(
                    self.grid, cl, x, self.nlocal, caps.nlocal_pad,
                    self.rcap, p.cutneigh, brcap=self.ubr,
                    ucol=self.ucl, zw=self.zw, ccap=self.ccap,
                )
                rovf = rovf | cl.overflow
            dummy = jnp.zeros((1, 8), jnp.int32)
            nlist = NeighborList(
                neighbors=dummy, numneigh=dummy[0],
                overflow=rovf, rows=rows, numrows=numrows, ncmax=ncmax,
            )
            return x, types, halo, nlist, halo.overflow | nlist.overflow
        cl = build_cells(self.grid, x)
        nlist = build_neighbors(
            self.grid, cl, x, types,
            self.cutneighsq if self.tables is None else self.tables.cutneighsq,
            self.nlocal, caps.nlocal_pad, caps.maxneighs,
            half=bool(p.half_neigh),
        )
        overflow = halo.overflow | nlist.overflow
        return x, types, halo, nlist, overflow

    def per_atom_lists(self, x, types) -> NeighborList:
        """Per-atom verlet lists from current coordinates, for stats
        and tracing consumers (reference numneigh/neighbors arrays).
        The rowlist fast path never materializes these in the run loop."""
        caps, p = self.caps, self.params

        def build(x, types):
            cl = build_cells(self.grid, x)
            return build_neighbors(
                self.grid, cl, x, types,
                self.cutneighsq if self.tables is None
                else self.tables.cutneighsq,
                self.nlocal, caps.nlocal_pad, caps.maxneighs,
                half=bool(p.half_neigh),
            )

        return jax.jit(build)(x, types)

    def _force(self, x, types, nlist, halo):
        with jax.named_scope("force"):  # LIKWID "force" region analogue
            return self._force_inner(x, types, nlist, halo)

    def _force_inner(self, x, types, nlist, halo):
        p, caps = self.params, self.caps
        if p.force_field == FF_LJ:
            if p.half_neigh:
                return lj_ops.compute_force_lj_half(
                    x, nlist.neighbors, nlist.numneigh, self.nlocal,
                    caps.nlocal_pad, self.cutforcesq, p.sigma6, p.epsilon,
                    types=types, tables=self.tables,
                )
            if self._rowlist:
                return compute_force_lj_rowlist(
                    x, nlist.rows, nlist.numrows, caps.nlocal_pad,
                    self.cutforcesq, p.sigma6, p.epsilon,
                    kernel=self._kmode, interpret=self.interpret,
                )
            return lj_ops.compute_force_lj_full(
                x, nlist.neighbors, nlist.numneigh, caps.nlocal_pad,
                self.cutforcesq, p.sigma6, p.epsilon,
                types=types, tables=self.tables,
            )
        elif p.force_field == FF_EAM:
            from mdbench_tpu.ops.eam import (
                compute_force_eam,
                compute_force_eam_poly,
            )

            if self.eam_poly is not None:
                f, _fp = compute_force_eam_poly(
                    x, nlist.neighbors, nlist.numneigh, halo.border_map,
                    self.nlocal, caps.nlocal_pad, p.cutforce**2,
                    self.eam_dev, self.eam_poly,
                )
                return f
            f, _fp = compute_force_eam(
                x, nlist.neighbors, nlist.numneigh, halo.border_map,
                self.nlocal, caps.nlocal_pad, p.cutforce**2, self.eam_dev,
            )
            return f
        raise ValueError("unknown force field")

    # -- the jitted run ----------------------------------------------------

    def _make_run_fn(self, ntimes: int):
        """The whole run as nested scans: outer over reneighbor intervals,
        inner over plain steps. The reneighbor step is a separate trace —
        no lax.cond in the hot loop."""
        p = self.params
        dt, dtforce = p.dt, self.dtforce
        nlocal = self.nlocal
        caps = self.caps
        mass, scales = p.mass, self.scales
        every = p.reneigh_every
        n_intervals = ntimes // every
        tail = ntimes - n_intervals * every

        # spatial resort cadence — EXACT reference semantics
        # (verletlist/main.c:83-87): the resort fires at a reneighbor
        # step iff that global step index is a multiple of
        # resort_every, so unaligned cadences fire at the common
        # multiples, exactly as the C loop does (e.g. resort 50 /
        # reneigh 20 -> steps 100, 200, ...).
        resort = p.resort_every if p.sort_atoms else 0
        if self._rowlist and p.sort_atoms:
            # The rowlist scheme REQUIRES id-order ~ space locality: the
            # unit-granular build and the rcap/ccap calibration assume
            # bin-sorted locals (derive_rowlists_from_cells). Between
            # resorts the melt decays that correlation — measured at
            # nx=8/50 steps: post-bbox candidates 62 -> 319 and numrows
            # 47 -> 140 by the second rebuild, overflowing any sane
            # t=0-calibrated margin (and at 131k bloating rcap 104 ->
            # 192, taxing every force step). So on this path the resort
            # rides EVERY reneighbor — the same structural choice as
            # the reference cluster scheme, which re-tiles clusters at
            # each rebuild (clusterpair/neighbor.c:663 buildClusters).
            resort = every

        def thermo(v):
            if p.dense_thermo:
                return compute_thermo(v, nlocal, mass, scales)
            z = jnp.zeros((), v.dtype)
            return z, z

        def plain_scan(state: StepState, n: int):
            """n plain steps carrying ONLY (x, v, f): the lists, halo,
            and types are rebuild-invariant — keeping them in the scan
            carry makes XLA thread (and sometimes copy) the ~100 MB
            neighbor array through every step (same lesson as
            engine_cluster._plain_scan)."""
            halo, nlist, types = state.halo, state.nlist, state.types

            def body(mv, _):
                x, v, f = mv
                x, v = initial_integrate(x, v, f, dt, dtforce, nlocal)
                x = update_pbc(x, halo, caps.nlocal_pad)
                f = self._force(x, types, nlist, halo)
                # differential in-loop FORCE timing (cli --timers diff):
                # chain extra data-dependent force passes so XLA can't
                # CSE them; T(reps=2) - T(reps=1) = one in-loop force
                for _r in range(self._force_reps - 1):
                    f = self._force(
                        x.at[: caps.nlocal_pad].add(1e-30 * f),
                        types, nlist, halo,
                    )
                v = final_integrate(v, f, dtforce, nlocal)
                t, pr = thermo(v)
                return (x, v, f), (t, pr)

            (x, v, f), tp = jax.lax.scan(
                body, (state.x, state.v, state.f), None, length=n
            )
            return state._replace(x=x, v=v, f=f), tp

        def reneigh_step(state: StepState, do_resort: bool = False):
            x, v = initial_integrate(state.x, state.v, state.f, dt, dtforce, nlocal)
            types = state.types
            if do_resort:
                from mdbench_tpu.ops.cells import sort_atoms_device
                from mdbench_tpu.ops.integrate import wrap_into_box

                # wrap BEFORE sorting: the sort must bin atoms at their
                # wrapped positions, or a 16-row holding a boundary atom
                # that wraps afterwards spans the whole box and defeats
                # every bbox prune (measured at nx=8: post-bbox
                # candidates 122 -> 234 without the pre-wrap)
                x = wrap_into_box(x, self.prd, nlocal)
                x, v, types = sort_atoms_device(
                    self.grid, x, v, types, nlocal
                )
            x, types, halo, nlist, ovf = self._reneighbor(x, v, types)
            f = self._force(x, types, nlist, halo)
            v = final_integrate(v, f, dtforce, nlocal)
            # reneighbor-boundary thermo always computed (like
            # engine_cluster): the golden gate reads these rows even
            # with dense_thermo off
            t, pr = compute_thermo(v, nlocal, mass, scales)
            new_state = StepState(
                x=x, v=v, f=f, types=types, halo=halo, nlist=nlist,
                overflow=state.overflow | ovf,
            )
            return new_state, (t, pr)

        def interval(state: StepState, _, do_resort: bool = False):
            state, tp_a = plain_scan(state, every - 1)
            state, tp_b = reneigh_step(state, do_resort)
            tp = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b[None]]), tp_a, tp_b
            )
            return state, tp

        # consecutive same-kind intervals roll up into one lax.scan
        # (the compiled program stays small; same scheme as
        # engine_cluster's resort segments)
        sort_flags = [
            bool(resort > 0 and ((i + 1) * every) % resort == 0)
            for i in range(n_intervals)
        ]
        segments = []  # [do_resort, count]
        for fl in sort_flags:
            if segments and segments[-1][0] == fl:
                segments[-1][1] += 1
            else:
                segments.append([fl, 1])

        def run(state: StepState, _flags):
            tp_parts = []
            for fl, count in segments:
                state, tps = jax.lax.scan(
                    lambda s, _, fl=fl: interval(s, None, do_resort=fl),
                    state, None, length=count,
                )
                tp_parts.append(
                    jax.tree_util.tree_map(lambda a: a.reshape(-1), tps)
                )
            if tail:
                state, tp_t = plain_scan(state, tail)
                tp_parts.append(tp_t)
            if tp_parts:
                temps = jnp.concatenate([t[0] for t in tp_parts])
                press = jnp.concatenate([t[1] for t in tp_parts])
            else:
                temps = jnp.zeros((0,), state.v.dtype)
                press = jnp.zeros((0,), state.v.dtype)
            return state, (temps, press)

        return jax.jit(run, donate_argnums=(0,))

    def _initial_state(self, x0, v0, types0) -> StepState:
        """Setup-equivalent state: ghosts + lists built, step-0 forces
        computed (reference: setup() + first computeForce, main.c:234-250).
        """
        x, types, halo, nlist, ovf = self._reneighbor(x0, v0, types0)
        f = self._force(x, types, nlist, halo)
        return StepState(
            x=x, v=v0, f=f, types=types, halo=halo, nlist=nlist, overflow=ovf
        )

    def initial_state(self) -> StepState:
        return jax.jit(self._initial_state)(self.x0, self.v0, self.types0)

    def run(self, ntimes: Optional[int] = None, max_retries: int = 3) -> RunResult:
        p = self.params
        ntimes = p.ntimes if ntimes is None else ntimes
        flags = np.arange(1, ntimes + 1) % p.reneigh_every == 0

        for attempt in range(max_retries + 1):
            state0 = self.initial_state()
            jax.block_until_ready(state0)
            if self._calibrate_rcap(state0):
                state0 = self.initial_state()
                jax.block_until_ready(state0)
            if ntimes >= p.reneigh_every and self._calibrate_melted(state0):
                state0 = self.initial_state()
                jax.block_until_ready(state0)
            run_fn = self._make_run_fn(ntimes)
            flags_dev = jnp.asarray(flags)
            # AOT-compile so the timed region is pure execution, matching
            # the reference timer protocol (main.c:250-287).
            t0 = time.perf_counter()
            compiled = run_fn.lower(state0, flags_dev).compile()
            compile_time = time.perf_counter() - t0
            # un-timed warm-up execution: the timed region below is the
            # steady loop, as in the reference's timer protocol
            jax.block_until_ready(compiled(self.initial_state(), flags_dev))
            t0 = time.perf_counter()
            state, (temps, press) = compiled(state0, flags_dev)
            jax.block_until_ready((state, temps, press))
            total = time.perf_counter() - t0

            if not bool(state.overflow):
                return RunResult(
                    temps=np.asarray(temps),
                    press=np.asarray(press),
                    state=state,
                    total_time=total,
                    force_time=float("nan"),
                    neigh_time=float("nan"),
                    compile_time=compile_time,
                )
            self._grow_caps(state)
        raise RuntimeError("capacity overflow persisted after retries")

    def _calibrate_rcap(self, state0) -> bool:
        """Shrink the row-list capacity to the observed max numrows
        + 50% heating margin (the XLA twin pads EVERY unit to rcap, and
        the derive's width scales with it, so a slack cap taxes every
        step). One-shot; run-time
        overflow still grows rcap via the retry loop. Same scheme as
        ClusterSimulation._calibrate_list_cap."""
        if self._rcap_calibrated:
            return False
        self._rcap_calibrated = True
        if not self._rowlist:
            # planar/EAM paths: shrink the list width to the observed
            # max numneigh + drift margin — every per-pair lane AND
            # (for EAM) every per-pair spline row gather scales with K
            kobs = int(np.asarray(state0.nlist.numneigh).max())
            kt = max((int(kobs * 1.2) + 7) // 8 * 8, 16)
            if kt < self.caps.maxneighs:
                self.caps = self.caps._replace(maxneighs=kt)
                self._build_device_state()
                return True
            return False
        nrh = np.asarray(state0.nlist.numrows)
        nrmax = int(nrh.max())
        target = max((int(nrmax * 1.5) + 7) // 8 * 8, 16)
        changed = False
        # move BOTH ways: growing here (heating margin over the t=0
        # max) is cheaper than paying a full run + overflow retry
        if target != self.rcap:
            self.rcap = target
            changed = True
        # candidate cap from the observed post-bbox maximum (+40%
        # heating margin): the exact-prune coordinate gather and lane
        # count scale with ccap
        if state0.nlist.ncmax is not None:
            st_ = np.asarray(state0.nlist.ncmax)
            ct = max((int(int(st_[0]) * 1.4) + 7) // 8 * 8, 24)
            if ct != self.ccap:
                self.ccap = ct
                changed = True
            changed = self._set_struct_caps(st_) or changed
        if changed:
            self._build_device_state()
        return changed

    def _calibrate_melted(self, state0, max_retries: int = 3) -> bool:
        """Second calibration pass on a MELTED box (rowlist path): run
        one throwaway reneighbor interval from t=0 and re-set rcap/ccap
        from that rebuild's observed numrows/ncmax. The benchmark starts
        from a perfect lattice whose row/candidate counts undershoot the
        liquid steady state by ~1.5-2x (at nx=8: numrows max 47 -> 66,
        post-bbox candidates 62 -> 122 by the first rebuild);
        calibrating on the lattice alone either loses the overflow race
        or forces bloated retry caps that slow every rebuild. One probe
        interval (compile + ~20 steps, outside the timed region) buys
        liquid-tight caps. GPU kernel path only: elsewhere the probe's
        extra interval compile taxes every test, and correctness is
        already covered by the targeted grow-and-retry."""
        if (self._kmode != "rowlist_pl" or self.interpret
                or self._melt_calibrated):
            return False
        self._melt_calibrated = True
        every = self.params.reneigh_every
        changed = False
        for _ in range(max_retries + 1):
            probe_fn = self._make_run_fn(every)
            st1, _tp = probe_fn(state0, jnp.zeros((0,)))
            jax.block_until_ready(st1.nlist.numrows)
            if bool(np.asarray(st1.overflow)):
                self._grow_caps(st1)
                state0 = self.initial_state()
                changed = True
                continue
            nrh = np.asarray(st1.nlist.numrows)
            rt = max((int(nrh.max() * 1.3) + 7) // 8 * 8, 16)
            if rt != self.rcap:
                self.rcap = rt
                changed = True
            # ghost capacity: update_pbc gathers + writes the FULL
            # padded ghost block every plain step, so slack here taxes
            # the whole run. The liquid's surface-shell count is
            # stable; 1.25x margin + the overflow retry backstops drift.
            ng = int(np.asarray(st1.halo.nghost))
            gt = max((int(ng * 1.25) + 15) // 16 * 16, 512)
            if gt != self.caps.ghost:
                self.caps = self.caps._replace(ghost=gt)
                changed = True
            if st1.nlist.ncmax is not None:
                st_ = np.asarray(st1.nlist.ncmax)
                ct = max(
                    (int(int(st_[0]) * 1.3) + 7) // 8 * 8, 24
                )
                if ct != self.ccap:
                    self.ccap = ct
                    changed = True
                changed = self._set_struct_caps(st_) or changed
            break
        if changed:
            self._build_device_state()
        return changed

    def _set_struct_caps(self, stats,
                         grow_only: bool = False) -> bool:
        """Set the row-build structural caps (ucol/zw/brcap) from a
        build's observed maxima (derive_rowlists_from_cells stats
        vector: [ncmax, dcolmax, zspanmax, brmax]) with +1/+2 drift
        headroom. grow_only: never shrink (overflow-retry path — the
        observed maxima come from a FAILED build and may
        underestimate)."""
        dmax, zmax, bmax = (int(stats[1]), int(stats[2]), int(stats[3]))
        if self._rowbuild_ranges:
            # ranges build stats: [cand, dcol, n_ranges, 0]
            want = {
                "ucl": max(dmax + 1, 2),
                "ukr": max((zmax + 6 + 7) // 8 * 8, 16),
            }
        else:
            want = {
                "ucl": max(dmax + 1, 2),
                "zw": max(zmax + 3, 3),
                "ubr": max(bmax + 2, 4),
            }
        changed = False
        for name, w in want.items():
            cur = getattr(self, name)
            if w > cur or (not grow_only and w < cur):
                setattr(self, name, w)
                changed = True
        return changed

    def _grow_caps(self, state=None):
        """Grow every overflowable capacity and rebuild device state
        (reference RESIZE semantics). When the failed run's final state
        is available, grow rcap/ccap to at least the OBSERVED maxima
        (the last rebuild's numrows/ncmax ride the state) — a blind
        1.5x ladder from a tightly calibrated base can lose the race
        against a fast-melting box."""
        self.caps = self.caps._replace(
            ghost=int(self.caps.ghost * 1.5),
            maxneighs=int(self.caps.maxneighs * 1.3) // 8 * 8 + 8,
            cell=int(self.caps.cell * 1.5) // 8 * 8 + 8,
        )
        self.rcap = int(self.rcap * 1.6 + 7) // 8 * 8
        self.ccap = int(self.ccap * 1.5 + 7) // 8 * 8
        grew_struct = False
        if state is not None and self._rowlist:
            nrmax = int(np.asarray(state.nlist.numrows).max())
            self.rcap = max(self.rcap, (int(nrmax * 1.5) + 7) // 8 * 8)
            if state.nlist.ncmax is not None:
                st_ = np.asarray(state.nlist.ncmax)
                self.ccap = max(
                    self.ccap, (int(int(st_[0]) * 1.4) + 7) // 8 * 8
                )
                grew_struct = self._set_struct_caps(st_, grow_only=True)
        if not grew_struct:
            # no observed stats (or none grew): blind structural ladder
            self.ucl += 2
            self.zw += 1
            self.ubr += 8
            self.ukr += 16
        self._build_device_state()

    def _restart_from(self, xb, vb, tb, failed_state=None,
                      max_retries: int = 3) -> "StepState":
        """Grow capacities and rebuild a runnable state from host
        snapshots of the local atoms (a chunk-boundary restart point).
        The restart point becomes the engine's new t=0 arrays, so
        initial_state() re-derives ghosts/lists/forces under the grown
        capacities — deterministically identical physics (lists are a
        pure function of positions; extra padding adds exact zeros)."""
        self._x0, self._v0, self._types0 = xb, vb, tb
        self._grow_caps(failed_state)
        for _ in range(max_retries + 1):
            state = self.initial_state()
            jax.block_until_ready(state)
            if not bool(np.any(np.asarray(state.overflow))):
                return state
            self._grow_caps()
        raise RuntimeError("capacity overflow persisted in restart")

    def run_chunked(self, chunk: int, nchunks: int, callback,
                    max_retries: int = 3, tail: int = 0):
        """Run in host-visible chunks for trajectory output: the fused
        scan covers `chunk` steps per call; `callback(state, step)` runs
        on host between chunks (the reference writes VTK/XTC inside its
        loop, main.c:282-284 — here output cadence must divide into
        chunks, e.g. chunk = x_out_every).

        Same capacity protocol as run(): rcap calibration before the
        timed region, and overflow-flag checks. A mid-run overflow never
        aborts (the reference's in-loop resize loop never does either,
        neighbor.c:247-262): the failed chunk's output is discarded, the
        capacities grow, the state rebuilds from the last good chunk
        boundary, and the chunk REPLAYS — the written trajectory equals
        an uninterrupted run's."""
        for _ in range(max_retries + 1):
            state = self.initial_state()
            jax.block_until_ready(state)
            if bool(np.any(np.asarray(state.overflow))):
                self._grow_caps()
                continue
            if self._calibrate_rcap(state):
                state = self.initial_state()
                jax.block_until_ready(state)
            if (nchunks * chunk + tail >= self.params.reneigh_every
                    and self._calibrate_melted(state)):
                state = self.initial_state()
                jax.block_until_ready(state)
            break
        else:
            raise RuntimeError("capacity overflow persisted after retries")
        callback(state, 0)
        compiled = (
            self._make_run_fn(chunk).lower(state, jnp.zeros((0,)))
            .compile()
            if nchunks > 0 else None
        )
        temps_all, press_all = [], []
        t0 = time.perf_counter()
        retries = 0
        c = 0
        while c < nchunks:
            # boundary snapshot (local atoms only) BEFORE the chunk: the
            # chunk call donates the state buffers, and a failed chunk's
            # output state is truncated garbage
            xb = np.asarray(state.x[: self.nlocal])
            vb = np.asarray(state.v[: self.nlocal])
            tb = np.asarray(state.types[: self.nlocal])
            state, (temps, press) = compiled(state, jnp.zeros((0,)))
            if bool(np.any(np.asarray(state.overflow))):
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        "capacity overflow persisted in run_chunked"
                    )
                state = self._restart_from(xb, vb, tb, state)
                compiled = (
                    self._make_run_fn(chunk)
                    .lower(state, jnp.zeros((0,))).compile()
                )
                continue  # replay chunk c from the boundary state
            callback(state, (c + 1) * chunk)
            temps_all.append(np.asarray(temps))
            press_all.append(np.asarray(press))
            c += 1
        if tail:
            # remainder steps so nchunks*chunk + tail == ntimes exactly
            # (the reference loop runs precisely -n steps)
            while True:
                xb = np.asarray(state.x[: self.nlocal])
                vb = np.asarray(state.v[: self.nlocal])
                tb = np.asarray(state.types[: self.nlocal])
                compiled_t = (
                    self._make_run_fn(tail).lower(state, jnp.zeros((0,)))
                    .compile()
                )
                state, (temps, press) = compiled_t(state, jnp.zeros((0,)))
                if not bool(np.any(np.asarray(state.overflow))):
                    break
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        "capacity overflow persisted in the tail chunk"
                    )
                state = self._restart_from(xb, vb, tb, state)
            callback(state, nchunks * chunk + tail)
            temps_all.append(np.asarray(temps))
            press_all.append(np.asarray(press))
        jax.block_until_ready(state)
        total = time.perf_counter() - t0
        return RunResult(
            temps=np.concatenate(temps_all),
            press=np.concatenate(press_all),
            state=state, total_time=total,
            force_time=float("nan"), neigh_time=float("nan"),
        )

    def measure_phases(self, state: StepState, reps: int = 20):
        """Out-of-band FORCE / NEIGH phase timing.

        The production path fuses the whole run into one program with no
        phase boundaries, so the reference's per-call timers
        (main.c:250-287) are reproduced by timing the jitted phase
        functions standalone on a representative state.
        Returns (force_seconds_per_call, reneigh_seconds_per_call).
        """
        # chained scans make every pass depend on the previous one
        @jax.jit
        def force_reps(x, types, nlist, halo):
            def body(x, _):
                f = self._force(x, types, nlist, halo)
                return x + 1e-30 * f[:, :1].sum(), ()

            x, _ = jax.lax.scan(body, x, None, length=reps)
            return x

        @jax.jit
        def reneigh_reps(x, v, types):
            def body(carry, _):
                x, types = carry
                x2, types2, halo, nlist, ovf = self._reneighbor(x, v, types)
                x2 = x2 + 1e-30 * nlist.numneigh[0].astype(x2.dtype)
                return (x2, types2), ()

            carry, _ = jax.lax.scan(body, (x, types), None, length=max(reps // 4, 1))
            return carry[0]

        args = (state.x, state.types, state.nlist, state.halo)
        jax.block_until_ready(force_reps(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(force_reps(*args))
        t_force = (time.perf_counter() - t0) / reps

        n_ren = max(reps // 4, 1)
        jax.block_until_ready(reneigh_reps(state.x, self.v0, state.types))
        t0 = time.perf_counter()
        jax.block_until_ready(reneigh_reps(state.x, self.v0, state.types))
        t_neigh = (time.perf_counter() - t0) / n_ren
        return t_force, t_neigh

    # Convenience for tests ------------------------------------------------

    def first_force(self) -> np.ndarray:
        for _ in range(5):
            state = self.initial_state()
            if not bool(np.asarray(state.overflow)):
                return np.asarray(state.f[: self.nlocal])
            self._grow_caps()
        raise RuntimeError("capacity overflow persisted after retries")
