"""3-D multi-chip spatial domain decomposition (verlet scheme).

Generalizes the staged-axis pattern of verlet_domain2d.py to BRICKS over
a (px, py, pz) mesh: every box axis is distributed, so there are no
locally-periodic ghosts at all — periodicity rides the ppermute rings.
Migration is three staged hops (x, then y, then z: an atom that crossed
a corner reaches the diagonal device in at most three hops), and the
ghost exchange is three staged face exchanges where each later stage
scans everything received so far, which covers all 12 edge and 8 corner
regions without diagonal channels (cf. the reference's explicit
face/edge/corner ghost walks, pbc.c:90-227).

Per-device row layout:
  [0, acap)            locals (sentinel padded)
  [+bx) [+bx)          x-ghosts from left / right
  [+by) [+by)          y-ghosts from down / up (incl. x-ghost images)
  [+bz) [+bz)          z-ghosts from below / above (incl. x/y images)
  [last]               sentinel row
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mdbench_tpu.backend import resolve_kernel
from mdbench_tpu.config import Params
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.cells import build_cells, make_cell_grid
from mdbench_tpu.ops.lj import compute_force_lj_full
from mdbench_tpu.ops.verlet import (
    build_neighbors,
    compute_force_lj_rowlist,
    derive_rowlists_from_cells,
)
from mdbench_tpu.state import SENTINEL_COORD
from mdbench_tpu.thermo import adjust_thermo, adjusted_dtforce, setup_thermo

AXES = ("dx", "dy", "dz")


class Domain3DResult(NamedTuple):
    temps: np.ndarray
    nlocal: np.ndarray
    overflow: np.ndarray
    total_time: float


class Domain3DSimulation:
    """LJ MD over a (px, py, pz) brick mesh, fully staged halo."""

    def __init__(self, params: Params, px: int, py: int, pz: int,
                 x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None):
        self.params = params
        # EAM over the brick mesh: the fp ghost refresh is three staged
        # ppermute hops with the same face maps as the coordinate
        # refresh (no local halo here — the box is fully periodic over
        # the mesh axes). 3-D analogue of force_eam.c:117-120.
        self.eam_dev = None
        self.eam_poly = None
        if params.force_field != 0:  # FF_EAM
            from mdbench_tpu.models.eam_tables import (
                apply_eam_overrides,
                fit_eam_poly,
                load_eam,
            )
            from mdbench_tpu.ops.eam import EamDevice, use_poly_eval

            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            t = load_eam(params.eam_file)
            apply_eam_overrides(params, t)
            self.eam_dev = EamDevice.from_tables(t, params.dtype)
            if use_poly_eval(params):
                self.eam_poly = fit_eam_poly(t)
        self.pdims = (px, py, pz)
        prd = (params.xprd, params.yprd, params.zprd)
        self.w = tuple(prd[d] / self.pdims[d] for d in range(3))
        c = params.cutneigh
        assert all(wd >= c for wd in self.w), (
            f"brick {self.w} under cutneigh {c}"
        )
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        ndev_total = px * py * pz
        per_dev = self.natoms / ndev_total
        self.acap = int(math.ceil(per_dev * 1.3 / 8)) * 8 + 8
        # staged face-export capacities: stage d scans locals + all
        # earlier stages' ghosts; each face strip is (c / w_d) of an
        # extended brick
        scan = self.acap
        self.bcap = []
        for d in range(3):
            frac = c / self.w[d]
            cap = int(math.ceil(scan * frac * 2.0)) + 64
            self.bcap.append(cap)
            scan += 2 * cap
        self.migcap = int(math.ceil(self.acap * 0.25)) + 32
        vol = 4.0 / 3.0 * np.pi * c**3
        self.maxneighs = max(
            params.maxneighs, int(math.ceil(vol * params.rho * 1.3 / 8)) * 8
        )
        # per-device rowlist fast path (same scheme as verlet_domain);
        # EAM stays planar
        self._kmode, self.interpret = resolve_kernel(
            "verlet", params.precision, params.kernel,
            force_field=params.force_field,
        )
        self._rowlist = self._kmode in ("rowlist", "rowlist_pl")
        self.rcap, self.ccap, self.ucl, self.ubr = 64, 128, 6, 8
        self.zw = 5  # z-run width (unit-column zspan + 2, + drift)
        # melted-probe calibration tightens the generous initials
        # before the timed run (parallel/common.apply_rowlist_caps)
        self._calibrated = False
        self._probe_state = None
        self._fix_row_layout()
        # bin capacity: 2.5x the mean — FCC lattice planes alias against
        # the bin boundaries, so some bins run well above the mean and the
        # domain engines have no grow-and-retry loop (the single-chip
        # engines do)
        _box = np.array(self.w)
        _nb = [max(1, int(_box[d] // c)) for d in range(3)]
        _mean = params.rho * (_box[0]/_nb[0]) * (_box[1]/_nb[1]) * (_box[2]/_nb[2])
        self.grid = make_cell_grid(
            _box, c, params.rho,
            capacity=int(math.ceil(_mean * 2.5 / 8.0)) * 8,
        )
        devs = np.array(jax.devices()[:ndev_total]).reshape(px, py, pz)
        self.mesh = Mesh(devs, AXES)
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    def _init_host_state(self, x, v):
        dtype = self.params.dtype
        pd = self.pdims
        idx3 = [
            np.minimum((x[:, d] / self.w[d]).astype(np.int64), pd[d] - 1)
            for d in range(3)
        ]
        xs = np.full((pd[0], pd[1], pd[2], self.nrows, 3),
                     SENTINEL_COORD, np.float64)
        vs = np.zeros((pd[0], pd[1], pd[2], self.acap, 3), np.float64)
        counts = np.zeros(pd, np.int32)
        for i in range(pd[0]):
            for j in range(pd[1]):
                for k in range(pd[2]):
                    sel = np.nonzero(
                        (idx3[0] == i) & (idx3[1] == j) & (idx3[2] == k)
                    )[0]
                    n = len(sel)
                    assert n <= self.acap, "initial brick overflow"
                    off = np.array([i * self.w[0], j * self.w[1],
                                    k * self.w[2]])
                    xs[i, j, k, :n] = x[sel] - off
                    vs[i, j, k, :n] = v[sel]
                    counts[i, j, k] = n
        self.x0 = jnp.asarray(xs, dtype)
        self.v0 = jnp.asarray(vs, dtype)
        self.n0 = jnp.asarray(counts)

    # ---- per-device helpers ------------------------------------------------

    def _perm(self, n, sign):
        return [(i, (i + sign) % n) for i in range(n)]

    def _migrate_axis(self, x, v, nloc, d):
        acap, migcap = self.acap, self.migcap
        width = self.w[d]
        ndev = self.pdims[d]
        dtype = x.dtype
        rows = jnp.arange(acap, dtype=jnp.int32)
        live = rows < nloc
        xl = x[:acap]
        go_l = live & (xl[:, d] < 0.0)
        go_r = live & (xl[:, d] >= width)
        ovf_drift = jnp.any(
            live & ((xl[:, d] < -width) | (xl[:, d] >= 2 * width))
        )
        stay = live & ~go_l & ~go_r

        def pack(mask, sgn):
            sv = [0.0, 0.0, 0.0]
            sv[d] = sgn * width
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < migcap), pos, migcap)
            buf = jnp.full((migcap, 6), SENTINEL_COORD, dtype)
            payload = jnp.concatenate(
                [xl + jnp.asarray(sv, dtype), v[:acap]], axis=1
            )
            return buf.at[pos].set(payload, mode="drop"), cnt

        buf_l, cl = pack(go_l, +1.0)
        buf_r, cr = pack(go_r, -1.0)
        ovf = (cl > migcap) | (cr > migcap) | ovf_drift
        recv_r = jax.lax.ppermute(buf_l, AXES[d], self._perm(ndev, -1))
        recv_l = jax.lax.ppermute(buf_r, AXES[d], self._perm(ndev, +1))

        pos = jnp.cumsum(stay) - 1
        n_stay = jnp.sum(stay).astype(jnp.int32)
        pos = jnp.where(stay, pos, acap)
        x2 = jnp.full((self.nrows, 3), SENTINEL_COORD, dtype)
        v2 = jnp.zeros((acap, 3), dtype)
        x2 = x2.at[pos].set(xl, mode="drop")
        v2 = v2.at[pos].set(v[:acap], mode="drop")

        def append(x2, v2, n, buf):
            valid = jnp.abs(buf[:, 0]) < SENTINEL_COORD * 0.5
            pos = jnp.cumsum(valid) - 1 + n
            cnt = jnp.sum(valid).astype(jnp.int32)
            pos = jnp.where(valid & (pos < acap), pos, acap)
            x2 = x2.at[pos].set(buf[:, 0:3], mode="drop")
            v2 = v2.at[pos].set(buf[:, 3:6], mode="drop")
            return x2, v2, n + cnt

        x2, v2, n2 = append(x2, v2, n_stay, recv_l)
        x2, v2, n2 = append(x2, v2, n2, recv_r)
        return x2, v2, n2, ovf | (n2 > acap)

    def _stage_base(self, d):
        return self.acap + 2 * sum(self.bcap[:d])

    def _build_maps_axis(self, x, d):
        """Face-export maps for axis d over locals + stages < d."""
        c = self.params.cutneigh
        nscan = self._stage_base(d)
        cap = self.bcap[d]
        xr = x[:nscan]
        ids = jnp.arange(nscan, dtype=jnp.int32)
        live = jnp.abs(xr[:, 0]) < SENTINEL_COORD * 0.5

        def pack(mask):
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < cap), pos, cap)
            m = jnp.full((cap,), self.nrows - 1, jnp.int32)
            return m.at[pos].set(ids, mode="drop"), cnt

        ml, cl = pack(live & (xr[:, d] < c))
        mr, cr = pack(live & (xr[:, d] >= self.w[d] - c))
        return ml, mr, (cl > cap) | (cr > cap)

    def _exchange_axis(self, x, d, ml, mr):
        dtype = x.dtype
        ndev = self.pdims[d]
        sv = [0.0, 0.0, 0.0]
        sv[d] = self.w[d]
        shift = jnp.asarray(sv, dtype)
        send_l = x[ml] + shift
        send_r = x[mr] - shift
        from_r = jax.lax.ppermute(send_l, AXES[d], self._perm(ndev, -1))
        from_l = jax.lax.ppermute(send_r, AXES[d], self._perm(ndev, +1))
        g0 = self._stage_base(d)
        cap = self.bcap[d]
        x = x.at[g0 : g0 + cap].set(from_l)
        x = x.at[g0 + cap : g0 + 2 * cap].set(from_r)
        return x

    def _fix_row_layout(self):
        from mdbench_tpu.parallel.common import round16

        if self._rowlist:
            self.acap = round16(self.acap)
            self.bcap = [round16(b) for b in self.bcap]
        tail = 16 if self._rowlist else 1
        self.nrows = self.acap + 2 * sum(self.bcap) + tail

    def _resort_dev(self, x, v, nloc):
        from mdbench_tpu.parallel.common import resort_by_cell

        return resort_by_cell(self.grid, x, v, nloc, self.acap)

    def _reneighbor_dev(self, x, v, nloc, with_stats: bool = False):
        ovf_m = jnp.asarray(False)
        for d in range(3):
            x, v, nloc, o = self._migrate_axis(x, v, nloc, d)
            ovf_m = ovf_m | o
        if self._rowlist:
            x, v = self._resort_dev(x, v, nloc)
        maps = []
        ovf_b = jnp.asarray(False)
        for d in range(3):
            ml, mr, o = self._build_maps_axis(x, d)
            ovf_b = ovf_b | o
            x = self._exchange_axis(x, d, ml, mr)
            maps.append((ml, mr))
        cl = build_cells(self.grid, x)
        stats = None
        if self._rowlist:
            from mdbench_tpu.state import NeighborList

            rows, numrows, stats, rovf = derive_rowlists_from_cells(
                self.grid, cl, x, nloc, self.acap, self.rcap,
                self.params.cutneigh, brcap=self.ubr, ucol=self.ucl, zw=self.zw,
                ccap=self.ccap,
            )
            nlist = NeighborList(
                neighbors=rows, numneigh=numrows,
                overflow=cl.overflow | rovf,
            )
        else:
            nlist = build_neighbors(
                self.grid, cl, x, None, self.params.cutneigh**2,
                self.acap, self.acap, self.maxneighs, half=False,
            )
        ovf = jnp.stack([ovf_m, ovf_b, cl.overflow, nlist.overflow])
        if with_stats:
            return x, v, nloc, maps, nlist, ovf, stats
        return x, v, nloc, maps, nlist, ovf

    def _refresh_ghosts(self, x, maps):
        for d in range(3):
            x = self._exchange_axis(x, d, maps[d][0], maps[d][1])
        return x

    # ---- the sharded run ---------------------------------------------------

    def _make_run_fn(self, ntimes: int):
        p = self.params
        dt, dtf = p.dt, self.dtforce
        every = p.reneigh_every
        n_int = max(ntimes // every, 1)
        mass, scales = p.mass, self.scales
        acap = self.acap

        def dev_body(x, v, nloc):
            x, v, nloc = x[0, 0, 0], v[0, 0, 0], nloc[0, 0, 0]
            rows = jnp.arange(acap, dtype=jnp.int32)

            def thermo(v, nloc):
                live = (rows < nloc)[:, None]
                vsq = jnp.sum(jnp.where(live, v * v, 0.0)) * mass
                return jax.lax.psum(vsq, AXES) * scales.t_scale

            def integrate1(x, v, f, nloc):
                live = (rows < nloc)[:, None]
                v = jnp.where(live, v + dtf * f, v)
                x = x.at[:acap].set(
                    jnp.where(live, x[:acap] + dt * v, x[:acap])
                )
                return x, v

            def force(x, nlist, maps):
                if self.eam_dev is not None:
                    def fp_exchange(fp):
                        # three staged hops with the coordinate maps
                        # (no shift: fp is translation invariant)
                        for d in range(3):
                            ml, mr = maps[d]
                            nd = self.pdims[d]
                            fr = jax.lax.ppermute(
                                fp[ml], AXES[d], self._perm(nd, -1)
                            )
                            fl = jax.lax.ppermute(
                                fp[mr], AXES[d], self._perm(nd, +1)
                            )
                            g0 = self._stage_base(d)
                            cap = self.bcap[d]
                            fp = fp.at[g0 : g0 + cap].set(fl)
                            fp = fp.at[g0 + cap : g0 + 2 * cap].set(fr)
                        return fp

                    from mdbench_tpu.ops.eam import (
                        compute_force_eam,
                        compute_force_eam_poly,
                    )

                    dummy_bm = maps[0][0]  # unused: fp_exchange given
                    if self.eam_poly is not None:
                        f, _fp = compute_force_eam_poly(
                            x, nlist.neighbors, nlist.numneigh,
                            dummy_bm, acap, acap, p.cutforce**2,
                            self.eam_dev, self.eam_poly,
                            fp_exchange=fp_exchange,
                        )
                    else:
                        f, _fp = compute_force_eam(
                            x, nlist.neighbors, nlist.numneigh,
                            dummy_bm, acap, acap, p.cutforce**2,
                            self.eam_dev, fp_exchange=fp_exchange,
                        )
                    return f
                if self._rowlist:
                    return compute_force_lj_rowlist(
                        x, nlist.neighbors, nlist.numneigh, acap,
                        p.cutforce**2, p.sigma6, p.epsilon,
                        kernel=self._kmode, interpret=self.interpret,
                    )
                return compute_force_lj_full(
                    x, nlist.neighbors, nlist.numneigh, acap,
                    p.cutforce**2, p.sigma6, p.epsilon,
                )

            def plain_scan(carry, n):
                # lean scan carry: only (x, v, f) is mutable between
                # rebuilds; per-step thermo (a psum collective) only
                # when dense_thermo asks (engine_cluster._plain_scan)
                x0, v0, f0, nloc, maps, nlist, ovf = carry
                live = (rows < nloc)[:, None]

                def body(mv, _):
                    x, v, f = mv
                    x, v = integrate1(x, v, f, nloc)
                    x = self._refresh_ghosts(x, maps)
                    f = force(x, nlist, maps)
                    v = jnp.where(live, v + dtf * f, v)
                    if p.dense_thermo:
                        t = thermo(v, nloc)
                    else:
                        t = jnp.zeros((), v.dtype)
                    return (x, v, f), t

                (x, v, f), ts = jax.lax.scan(
                    body, (x0, v0, f0), None, length=n
                )
                return (x, v, f, nloc, maps, nlist, ovf), ts

            def reneigh_step(carry):
                x, v, f, nloc, maps, nlist, ovf = carry
                x, v = integrate1(x, v, f, nloc)
                x, v, nloc, maps, nlist, ovf2 = (
                    self._reneighbor_dev(x, v, nloc)
                )
                f = force(x, nlist, maps)
                live = (rows < nloc)[:, None]
                v = jnp.where(live, v + dtf * f, v)
                t = thermo(v, nloc)
                return (
                    x, v, f, nloc, maps, nlist, ovf | jnp.any(ovf2)
                ), t

            def interval(carry, _):
                carry, ts = plain_scan(carry, every - 1)
                carry, t_last = reneigh_step(carry)
                return carry, jnp.concatenate([ts, t_last[None]])

            x, v, nloc, maps, nlist, ovf0 = self._reneighbor_dev(x, v, nloc)
            f = force(x, nlist, maps)
            carry = (x, v, f, nloc, maps, nlist, jnp.any(ovf0))
            carry, temps = jax.lax.scan(interval, carry, None, length=n_int)
            return (
                carry[0][None, None, None],
                carry[1][None, None, None],
                carry[3][None, None, None],
                carry[6][None, None, None],
                temps.reshape(1, 1, 1, -1),
            )

        spec = P(*AXES)
        sharded = jax.shard_map(
            dev_body, mesh=self.mesh,
            in_specs=(spec, spec, spec),
            out_specs=(spec,) * 5,
            check_vma=False,
        )
        return jax.jit(sharded)


    def _grow_and_reinit(self):
        self.acap = (int(self.acap * 1.4) + 39) // 8 * 8
        self.bcap = [int(b * 1.4) + 32 for b in self.bcap]
        self.migcap = int(self.migcap * 1.4) + 32
        self.maxneighs = (int(self.maxneighs * 1.4) + 7) // 8 * 8
        self.rcap = int(self.rcap * 1.6 + 7) // 8 * 8
        self.ccap = int(self.ccap * 1.5 + 7) // 8 * 8
        self.ucl += 2
        self.zw += 1
        self.ubr += 8
        self._fix_row_layout()
        self.grid = self.grid._replace(
            capacity=int(self.grid.capacity * 1.5 + 7) // 8 * 8
        )
        self._init_host_state(*self._xv_init)

    def _calibrate(self, ntimes: int, _retry: int = 4) -> None:
        """One-shot melted-probe cap calibration — same protocol as the
        1-D/2-D engines, cap-setting shared via parallel/common. The
        brick's three staged face-export caps are calibrated from the
        observed non-sentinel export-map occupancy per axis."""
        if self._calibrated or not self._rowlist:
            return
        self._calibrated = True
        every = self.params.reneigh_every
        if ntimes < every:
            return
        self._run_raw(every, _retry=_retry)
        xs, vs, nlocs = self._probe_state
        spec = P(*AXES)
        sent = self.nrows - 1

        def observe_dev(x, v, nloc):
            out = self._reneighbor_dev(
                x[0, 0, 0], v[0, 0, 0], nloc[0, 0, 0], with_stats=True
            )
            maps, nlist, stats = out[3], out[4], out[6]
            nbs = [
                jnp.maximum(
                    jnp.sum(ml != sent), jnp.sum(mr != sent)
                ).astype(jnp.int32)[None, None, None]
                for ml, mr in maps
            ]
            return (
                nlist.numneigh[None, None, None],
                stats[None, None, None],
                *nbs,
            )

        obs = jax.jit(jax.shard_map(
            observe_dev, mesh=self.mesh,
            in_specs=(spec, spec, spec), out_specs=(spec,) * 5,
            check_vma=False,
        ))
        nr, st, nb0, nb1, nb2 = obs(xs, vs, nlocs)
        from mdbench_tpu.parallel.common import (
            apply_rowlist_caps,
            calibrated_block_cap,
        )

        ndev = int(np.prod(self.pdims))
        apply_rowlist_caps(
            self, np.asarray(nr).reshape(ndev, -1),
            np.asarray(st).reshape(ndev, -1),
        )
        self.bcap = [
            calibrated_block_cap(int(np.asarray(nb).max()), 64)
            for nb in (nb0, nb1, nb2)
        ]
        self._fix_row_layout()
        self._init_host_state(*self._xv_init)

    def run(self, ntimes: Optional[int] = None,
            _retry: int = 6) -> Domain3DResult:
        ntimes = self.params.ntimes if ntimes is None else ntimes
        self._calibrate(ntimes)
        return self._run_raw(ntimes, _retry=_retry)

    def _run_raw(self, ntimes: int, _retry: int = 6) -> Domain3DResult:
        run_fn = self._make_run_fn(ntimes)
        # AOT-compile outside the timed region (same wall-clock protocol
        # as the single-chip engines)
        run_fn = run_fn.lower(self.x0, self.v0, self.n0).compile()
        # un-timed warm-up execution, as in the single-chip engines
        jax.block_until_ready(run_fn(self.x0, self.v0, self.n0))
        t0 = time.perf_counter()
        out = run_fn(self.x0, self.v0, self.n0)
        jax.block_until_ready(out)
        total = time.perf_counter() - t0
        x, v, nloc, ovf, temps = out
        nloc_h = np.asarray(nloc)
        ovf = np.asarray(ovf)
        if ovf.any():
            if _retry > 0:
                self._grow_and_reinit()
                return self._run_raw(ntimes, _retry=_retry - 1)
            raise RuntimeError("3-D domain capacity overflow")
        # melted device state for the calibration observe pass
        self._probe_state = (x, v, nloc)
        return Domain3DResult(
            temps=np.asarray(temps[0, 0, 0]).reshape(-1),
            nlocal=nloc_h, overflow=ovf, total_time=total,
        )
