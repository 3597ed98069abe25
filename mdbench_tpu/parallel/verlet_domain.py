"""Production multi-chip spatial domain decomposition (verlet scheme).

The reference is single-node; its ghost-atom PBC machinery (border_map +
shift vectors, src/verletlist/pbc.c) is exactly the pattern that
generalizes to chips (SURVEY §5.8). Decomposition: 1-D slabs along x
over a `jax.sharding.Mesh`; everything below runs inside `shard_map`,
so each device executes the same single-chip machinery (cells, padded
Verlet lists, planar LJ) on its slab, and the only cross-chip traffic is
`lax.ppermute` of fixed-capacity buffers between devices:

  reneighbor (every reneigh_every steps, all inside the jitted scan):
    wrap -> MIGRATE atoms that crossed a slab face (pack leavers into
    fixed buffers, ppermute left/right, merge) -> local y/z ghost build
    (setup_pbc with pbc=(0,1,1)) -> export both x-face boundary regions
    (locals + their y/z images, so edge/corner images ride along) ->
    ppermute -> received buffers become x-ghost rows -> bin + build
    padded neighbor lists per device
  every step:
    integrate -> refresh local y/z ghosts -> re-gather the exported
    border rows, ppermute both directions, refresh x-ghost rows ->
    force -> integrate (the reference's updatePbc, with the gather
    crossing chips)

Correctness requires slab width >= cutneigh and that atoms drift at most
one slab per reneighbor interval (flagged). Per-device row layout:
  [0, acap)               local atoms (sentinel padded)
  [acap, acap+gcap)       local y/z ghosts
  [+bcap)                 x-ghosts received from the left neighbor
  [+bcap)                 x-ghosts received from the right neighbor
  [last]                  sentinel row
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
from mdbench_tpu.ops.cells import make_cell_grid, build_cells
from mdbench_tpu.ops.lj import compute_force_lj_full
from mdbench_tpu.ops.pbc import setup_pbc, update_pbc
from mdbench_tpu.ops.verlet import (
    build_neighbors,
    compute_force_lj_rowlist,
    derive_rowlists_from_cells,
)
from mdbench_tpu.state import SENTINEL_COORD
from mdbench_tpu.thermo import adjust_thermo, adjusted_dtforce, setup_thermo

AXIS = "x"


class DomainState(NamedTuple):
    """Per-device arrays, sharded over the leading mesh axis."""

    x: jnp.ndarray  # (ndev, nrows, 3) — locals+ghosts+sentinel, slab frame
    v: jnp.ndarray  # (ndev, acap, 3)
    f: jnp.ndarray  # (ndev, acap, 3)
    nlocal: jnp.ndarray  # (ndev,) int32 — live atoms per device
    halo_map: jnp.ndarray  # (ndev, gcap) local y/z ghost owner rows
    halo_shift: jnp.ndarray  # (ndev, gcap, 3)
    bmap_l: jnp.ndarray  # (ndev, bcap) rows exported to the LEFT neighbor
    bmap_r: jnp.ndarray  # (ndev, bcap)
    neighbors: jnp.ndarray  # (ndev, acap, maxneighs)
    numneigh: jnp.ndarray  # (ndev, acap)
    overflow: jnp.ndarray  # (ndev, 4) [migration, ghosts, border, lists]


class DomainResult(NamedTuple):
    temps: np.ndarray
    state: DomainState
    total_time: float


def plan_capacities(params: Params, ndev: int, natoms: int) -> dict:
    """Capacity + memory plan for a domain run (e.g. 10M+ atoms over
    a multi-device mesh). Mirrors DomainSimulation.__init__'s
    formulas; returns per-device row capacities and a bytes/device
    estimate so configs can be validated against HBM before launching."""
    slab_w = params.xprd / ndev
    per_dev = natoms / ndev
    acap = int(math.ceil(per_dev * 1.10 / 8)) * 8 + 8
    c = params.cutneigh
    gfrac = (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd) - 1.0
    gcap = int(math.ceil(acap * gfrac * 1.6)) + 64
    bfrac = (c / slab_w) * (1 + 2 * c / params.yprd) * (
        1 + 2 * c / params.zprd
    )
    bcap = int(math.ceil(acap * bfrac * 1.8)) + 64
    migcap = int(math.ceil(acap * 0.2)) + 32
    vol = 4.0 / 3.0 * np.pi * c**3
    maxneighs = max(
        params.maxneighs, int(math.ceil(vol * params.rho * 1.3 / 8)) * 8
    )
    nrows = acap + gcap + 2 * bcap + 1
    fsize = 8 if params.precision == "dp" else 4
    bytes_per_dev = (
        nrows * 3 * fsize  # x
        + 2 * acap * 3 * fsize  # v, f
        + acap * maxneighs * 4  # neighbor list
        + acap * 4  # numneigh
        + gcap * (4 + 3 * fsize)  # halo map + shifts
        + 2 * bcap * 4  # border maps
    )
    return dict(
        slab_w=slab_w, acap=acap, gcap=gcap, bcap=bcap, migcap=migcap,
        maxneighs=maxneighs, nrows=nrows, bytes_per_device=bytes_per_dev,
        slab_ok=slab_w >= params.cutneigh,
    )


class DomainSimulation:
    """Multi-chip LJ MD via slab decomposition + ppermute halo exchange."""

    def __init__(self, params: Params, ndev: int,
                 x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None):
        self.params = params
        self.eam_dev = None
        self.eam_poly = None
        if params.force_field != 0:  # FF_EAM
            # EAM overrides params BEFORE lattice generation (main.c:38)
            from mdbench_tpu.models.eam_tables import (
                apply_eam_overrides,
                load_eam,
            )
            from mdbench_tpu.ops.eam import EamDevice, use_poly_eval

            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            t = load_eam(params.eam_file)
            apply_eam_overrides(params, t)
            dtype = params.dtype
            import jax.numpy as _jnp

            self.eam_dev = EamDevice.from_tables(t, dtype)
            # gather-free pair-evaluation fast axis (the fp_exchange
            # closure is orthogonal to the evaluation method)
            if use_poly_eval(params):
                from mdbench_tpu.models.eam_tables import fit_eam_poly

                self.eam_poly = fit_eam_poly(t)
        self.ndev = ndev
        self.slab_w = params.xprd / ndev
        assert self.slab_w >= params.cutneigh, (
            f"slab width {self.slab_w:.2f} < cutneigh {params.cutneigh}: "
            "use fewer devices or a larger box"
        )
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        per_dev = self.natoms / ndev
        # 1.10 margin: the rowlist kernel + lists pad to acap, so
        # slack taxes every step; per-rank melt density drift is
        # ~2% and the overflow-flag grow-retry backstops
        self.acap = int(math.ceil(per_dev * 1.10 / 8)) * 8 + 8
        c = params.cutneigh
        # y/z ghosts of a slab
        gfrac = (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd) - 1.0
        self.gcap = int(math.ceil(self.acap * gfrac * 1.6)) + 64
        # one x-face region incl. its y/z images
        bfrac = (c / self.slab_w) * (1 + 2 * c / params.yprd) * (
            1 + 2 * c / params.zprd
        )
        self.bcap = int(math.ceil(self.acap * bfrac * 1.8)) + 64
        self.migcap = int(math.ceil(self.acap * 0.2)) + 32
        vol = 4.0 / 3.0 * np.pi * c**3
        self.maxneighs = max(
            params.maxneighs, int(math.ceil(vol * params.rho * 1.3 / 8)) * 8
        )
        # per-device rowlist fast path (the single-chip kernel=rowlist:
        # packed 16-atom-row lists straight from the cell table + the
        # exact-list kernels) — LJ only; EAM stays planar
        self._kmode, self.interpret = resolve_kernel(
            "verlet", params.precision, params.kernel,
            force_field=params.force_field,
        )
        self._rowlist = self._kmode in ("rowlist", "rowlist_pl")
        # generous initial row-build caps; a one-shot probe interval
        # re-calibrates them from OBSERVED melted maxima before the timed
        # run (port of the single-chip rcap/melt calibration)
        self.rcap, self.ccap, self.ucl, self.ubr = 64, 128, 6, 8
        self.zw = 5  # z-run width (unit-column zspan + 2, + drift)
        self._calibrated = False
        self._fix_row_layout()

        # slab-local cell grid (same static geometry on every device)
        # bin capacity: 2.5x the mean — FCC lattice planes alias against
        # the bin boundaries, so some bins run well above the mean and the
        # domain engines have no grow-and-retry loop (the single-chip
        # engines do)
        _box = np.array([self.slab_w, params.yprd, params.zprd])
        _nb = [max(1, int(_box[d] // params.cutneigh)) for d in range(3)]
        _mean = params.rho * (_box[0]/_nb[0]) * (_box[1]/_nb[1]) * (_box[2]/_nb[2])
        self.grid = make_cell_grid(
            _box, params.cutneigh, params.rho,
            capacity=int(math.ceil(_mean * 2.5 / 8.0)) * 8,
        )
        self.mesh = Mesh(np.array(jax.devices()[:ndev]), (AXIS,))
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    def _fix_row_layout(self):
        """Row layout: rowlist mode needs whole 16-atom rows in the
        local, ghost and border regions and a 16-row all-sentinel tail;
        the planar path keeps one sentinel row."""
        from mdbench_tpu.parallel.common import round16

        if self._rowlist:
            self.acap = round16(self.acap)
            self.gcap = round16(self.gcap)
            self.bcap = round16(self.bcap)
        tail = 16 if self._rowlist else 1
        self.nrows = self.acap + self.gcap + 2 * self.bcap + tail

    def _init_host_state(self, x, v):
        p = self.params
        dtype = p.dtype
        slab = np.minimum(
            (x[:, 0] / self.slab_w).astype(np.int64), self.ndev - 1
        )
        xs = np.full((self.ndev, self.nrows, 3), SENTINEL_COORD, np.float64)
        vs = np.zeros((self.ndev, self.acap, 3), np.float64)
        counts = np.zeros(self.ndev, np.int32)
        for d in range(self.ndev):
            idx = np.nonzero(slab == d)[0]
            n = len(idx)
            assert n <= self.acap, "initial slab overflow"
            # slab frame: x shifted so the slab owns [0, slab_w)
            xs[d, :n] = x[idx] - np.array([d * self.slab_w, 0.0, 0.0])
            vs[d, :n] = v[idx]
            counts[d] = n
        self.x0 = jnp.asarray(xs, dtype)
        self.v0 = jnp.asarray(vs, dtype)
        self.n0 = jnp.asarray(counts)

    # ---- per-device phases (called inside shard_map) ----------------------

    def _wrap_yz(self, x, nloc):
        """Wrap y/z into the box; x is handled by migration."""
        p = self.params
        rows = jnp.arange(x.shape[0])[:, None]
        live = rows < nloc
        for d, prd in ((1, p.yprd), (2, p.zprd)):
            c = x[:, d]
            c = jnp.where(live[:, 0] & (c < 0), c + prd, c)
            c = jnp.where(live[:, 0] & (c >= prd), c - prd, c)
            x = x.at[:, d].set(c)
        return x

    def _migrate(self, x, v, nloc):
        """Move atoms that crossed a slab face to the neighbor device
        (the multi-chip analogue of updateAtomsPbc, pbc.c:59-84)."""
        p = self.params
        ndev = self.ndev
        acap, migcap = self.acap, self.migcap
        dtype = x.dtype
        rows = jnp.arange(acap, dtype=jnp.int32)
        live = rows < nloc
        xl = x[:acap]

        go_l = live & (xl[:, 0] < 0.0)
        go_r = live & (xl[:, 0] >= self.slab_w)
        ovf_drift = jnp.any(
            live & ((xl[:, 0] < -self.slab_w) | (xl[:, 0] >= 2 * self.slab_w))
        )
        stay = live & ~go_l & ~go_r

        def pack(mask, dx_shift):
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < migcap), pos, migcap)
            buf = jnp.full((migcap, 6), SENTINEL_COORD, dtype)
            payload = jnp.concatenate(
                [xl + jnp.asarray([dx_shift, 0, 0], dtype), v[:acap]], axis=1
            )
            buf = buf.at[pos].set(payload, mode="drop")
            return buf, cnt

        # leavers-left arrive at the left neighbor's right edge
        buf_l, cnt_l = pack(go_l, +self.slab_w)
        buf_r, cnt_r = pack(go_r, -self.slab_w)
        ovf_mig = (cnt_l > migcap) | (cnt_r > migcap) | ovf_drift

        perm_r = [(i, (i + 1) % ndev) for i in range(ndev)]
        perm_l = [(i, (i - 1) % ndev) for i in range(ndev)]
        recv_from_right = jax.lax.ppermute(buf_l, AXIS, perm_l)
        recv_from_left = jax.lax.ppermute(buf_r, AXIS, perm_r)

        # compact stayers to the front, then append arrivals
        pos = jnp.cumsum(stay) - 1
        n_stay = jnp.sum(stay).astype(jnp.int32)
        pos = jnp.where(stay, pos, acap)
        x2 = jnp.full((acap, 3), SENTINEL_COORD, dtype)
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

        x2, v2, n2 = append(x2, v2, n_stay, recv_from_left)
        x2, v2, n2 = append(x2, v2, n2, recv_from_right)
        ovf = ovf_mig | (n2 > acap)
        x_full = jnp.full((self.nrows, 3), SENTINEL_COORD, dtype)
        x_full = x_full.at[:acap].set(x2)
        return x_full, v2, n2, ovf

    def _build_halo(self, x, nloc):
        """Local y/z ghosts + x-face border export maps."""
        p = self.params
        acap, gcap, bcap = self.acap, self.gcap, self.bcap
        c = p.cutneigh
        # sentinel padding rows (coords ~1e30) would PASS the hi-side
        # boundary tests inside setup_pbc and spawn garbage ghosts; feed
        # it a copy with padding parked mid-box (fails both face tests).
        rows = jnp.arange(acap, dtype=jnp.int32)
        live = (rows < nloc)[:, None]
        center = jnp.asarray(
            [self.slab_w / 2, p.yprd / 2, p.zprd / 2], x.dtype
        )
        x_safe = x.at[:acap].set(jnp.where(live, x[:acap], center))
        halo = setup_pbc(
            x_safe, acap, acap, gcap,
            np.array([self.slab_w, p.yprd, p.zprd]),
            (0, p.pbc_y, p.pbc_z), c,
            # rowlist: cell-sorted ghosts keep ghost 16-rows spatially
            # compact (same lesson as the single-chip engine)
            sort_grid=self.grid if self._rowlist else None,
        )
        x = update_pbc(x, halo, acap)

        # export regions over locals + y/z ghosts
        nscan = acap + gcap
        xr = x[:nscan]
        row_ids = jnp.arange(nscan, dtype=jnp.int32)
        row_live = jnp.abs(xr[:, 0]) < SENTINEL_COORD * 0.5
        exp_l = row_live & (xr[:, 0] < c)
        exp_r = row_live & (xr[:, 0] >= self.slab_w - c)

        def pack_map(mask):
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < bcap), pos, bcap)
            bm = jnp.full((bcap,), x.shape[0] - 1, jnp.int32)
            bm = bm.at[pos].set(row_ids, mode="drop")
            return bm, cnt

        bmap_l, cl = pack_map(exp_l)
        bmap_r, cr = pack_map(exp_r)
        ovf = halo.overflow | (cl > bcap) | (cr > bcap)
        return x, halo, bmap_l, bmap_r, ovf

    def _exchange_borders(self, x, bmap_l, bmap_r):
        """Per-step x-ghost refresh: gather exported rows, shift across
        the periodic seam, ppermute both directions (the halo exchange
        proper — device-to-device traffic)."""
        dtype = x.dtype
        ndev = self.ndev

        # periodic seams are handled by slab-LOCAL frames: a +-slab_w
        # shift is correct for every neighbor pair, including the wrap
        # between device 0 and device ndev-1.
        # to LEFT neighbor: arrives at their right side: x += slab_w
        send_l = x[bmap_l] + jnp.asarray([self.slab_w, 0, 0], dtype)
        # to RIGHT neighbor: arrives at their left side: x -= slab_w
        send_r = x[bmap_r] - jnp.asarray([self.slab_w, 0, 0], dtype)

        perm_r = [(i, (i + 1) % ndev) for i in range(ndev)]
        perm_l = [(i, (i - 1) % ndev) for i in range(ndev)]
        from_right = jax.lax.ppermute(send_l, AXIS, perm_l)
        from_left = jax.lax.ppermute(send_r, AXIS, perm_r)

        g0 = self.acap + self.gcap
        x = x.at[g0 : g0 + self.bcap].set(from_left)
        x = x.at[g0 + self.bcap : g0 + 2 * self.bcap].set(from_right)
        return x

    def _resort_dev(self, x, v, nloc):
        from mdbench_tpu.parallel.common import resort_by_cell

        return resort_by_cell(self.grid, x, v, nloc, self.acap)

    def _reneighbor_dev(self, x, v, nloc, with_stats: bool = False):
        x = self._wrap_yz(x, nloc)
        x, v, nloc, ovf_m = self._migrate(x, v, nloc)
        if self._rowlist:
            x, v = self._resort_dev(x, v, nloc)
        x, halo, bmap_l, bmap_r, ovf_g = self._build_halo(x, nloc)
        x = self._exchange_borders(x, bmap_l, bmap_r)
        cl = build_cells(self.grid, x)
        if self._rowlist:
            from mdbench_tpu.state import NeighborList

            rows, numrows, stats, rovf = derive_rowlists_from_cells(
                self.grid, cl, x, nloc, self.acap, self.rcap,
                self.params.cutneigh, brcap=self.ubr, ucol=self.ucl, zw=self.zw,
                ccap=self.ccap,
            )
            # rows/numrows ride the neighbors/numneigh carry slots
            nlist = NeighborList(
                neighbors=rows, numneigh=numrows,
                overflow=cl.overflow | rovf,
            )
            ovf = jnp.stack(
                [ovf_m, ovf_g, cl.overflow, nlist.overflow]
            )
            if with_stats:
                return x, v, nloc, halo, bmap_l, bmap_r, nlist, ovf, stats
            return x, v, nloc, halo, bmap_l, bmap_r, nlist, ovf
        nlist = build_neighbors(
            self.grid, cl, x, None, self.params.cutneigh**2,
            self.acap, self.acap, self.maxneighs, half=False,
        )
        # mask rows beyond nloc (their sentinel coords never pass the
        # cutoff, but numneigh counting already handles it)
        ovf = jnp.stack(
            [ovf_m, ovf_g, cl.overflow, nlist.overflow]
        )
        return x, v, nloc, halo, bmap_l, bmap_r, nlist, ovf

    def _force_dev(self, x, nlist, halo, bmap_l, bmap_r):
        p = self.params
        if self._rowlist:
            # nlist.neighbors/numneigh carry the packed row lists here
            return compute_force_lj_rowlist(
                x, nlist.neighbors, nlist.numneigh, self.acap,
                p.cutforce**2, p.sigma6, p.epsilon, kernel=self._kmode,
                interpret=self.interpret,
            )
        if self.eam_dev is None:
            return compute_force_lj_full(
                x, nlist.neighbors, nlist.numneigh, self.acap,
                p.cutforce**2, p.sigma6, p.epsilon,
            )
        from mdbench_tpu.ops.eam import compute_force_eam

        acap, gcap, bcap = self.acap, self.gcap, self.bcap
        ndev = self.ndev

        def fp_exchange(fp):
            # local y/z ghost fp from owners, then x-border fp by ppermute
            # (the multi-chip force_eam.c:117-120)
            fp = fp.at[acap : acap + gcap].set(fp[halo.border_map])
            send_l = fp[bmap_l]
            send_r = fp[bmap_r]
            perm_r = [(i, (i + 1) % ndev) for i in range(ndev)]
            perm_l = [(i, (i - 1) % ndev) for i in range(ndev)]
            from_right = jax.lax.ppermute(send_l, AXIS, perm_l)
            from_left = jax.lax.ppermute(send_r, AXIS, perm_r)
            g0 = acap + gcap
            fp = fp.at[g0 : g0 + bcap].set(from_left)
            fp = fp.at[g0 + bcap : g0 + 2 * bcap].set(from_right)
            return fp

        if self.eam_poly is not None:
            from mdbench_tpu.ops.eam import compute_force_eam_poly

            f, _fp = compute_force_eam_poly(
                x, nlist.neighbors, nlist.numneigh, halo.border_map,
                acap, acap, p.cutforce**2, self.eam_dev, self.eam_poly,
                fp_exchange=fp_exchange,
            )
            return f
        f, _fp = compute_force_eam(
            x, nlist.neighbors, nlist.numneigh, halo.border_map,
            acap, acap, p.cutforce**2, self.eam_dev,
            fp_exchange=fp_exchange,
        )
        return f

    # ---- the sharded run ---------------------------------------------------

    def _make_run_fn(self, ntimes: int):
        p = self.params
        dt, dtf = p.dt, self.dtforce
        every = p.reneigh_every
        n_int = max(ntimes // every, 1)
        mass, scales = p.mass, self.scales

        def dev_body(x, v, f, nloc, hm, hs, bl, br, nb, nn, ovf):
            """One device's whole run; collectives inside."""
            from mdbench_tpu.state import Halo, NeighborList

            x, v, f = x[0], v[0], f[0]
            nloc = nloc[0]
            halo = Halo(border_map=hm[0], shift=hs[0],
                        nghost=jnp.int32(0), overflow=jnp.asarray(False))
            bl, br = bl[0], br[0]
            nlist = NeighborList(neighbors=nb[0], numneigh=nn[0],
                                 overflow=jnp.asarray(False))
            ovf = ovf[0]
            acap = self.acap
            rows = jnp.arange(acap, dtype=jnp.int32)

            def thermo(v, nloc):
                live = (rows < nloc)[:, None]
                vsq = jnp.sum(jnp.where(live, v * v, 0.0)) * mass
                vsq = jax.lax.psum(vsq, AXIS)
                return vsq * scales.t_scale

            def integrate1(x, v, f, nloc):
                live = (rows < nloc)[:, None]
                v = jnp.where(live, v + dtf * f, v)
                x = x.at[:acap].set(
                    jnp.where(live, x[:acap] + dt * v, x[:acap])
                )
                return x, v

            def plain_scan(carry, n):
                """n plain steps carrying ONLY (x, v, f): nloc, halo,
                borders, and the row lists are rebuild-invariant, and a
                fat scan carry makes XLA thread/copy the list arrays
                through every step (lean-carry lesson,
                engine_cluster._plain_scan). Per-step thermo is a psum'd
                collective — skipped unless dense_thermo asks for it."""
                x0, v0, f0, nloc, halo, bl, br, nlist, ovf = carry
                live = (rows < nloc)[:, None]

                def body(mv, _):
                    x, v, f = mv
                    x, v = integrate1(x, v, f, nloc)
                    x = update_pbc(x, halo, acap)
                    x = self._exchange_borders(x, bl, br)
                    f = self._force_dev(x, nlist, halo, bl, br)
                    v = jnp.where(live, v + dtf * f, v)
                    if p.dense_thermo:
                        t = thermo(v, nloc)
                    else:
                        t = jnp.zeros((), v.dtype)
                    return (x, v, f), t

                (x, v, f), ts = jax.lax.scan(
                    body, (x0, v0, f0), None, length=n
                )
                return (x, v, f, nloc, halo, bl, br, nlist, ovf), ts

            def reneigh_step(carry):
                x, v, f, nloc, halo, bl, br, nlist, ovf = carry
                x, v = integrate1(x, v, f, nloc)
                x, v, nloc, halo, bl, br, nlist, ovf2 = (
                    self._reneighbor_dev(x, v, nloc)
                )
                f = self._force_dev(x, nlist, halo, bl, br)
                live = (rows < nloc)[:, None]
                v = jnp.where(live, v + dtf * f, v)
                t = thermo(v, nloc)
                return (x, v, f, nloc, halo, bl, br, nlist, ovf | ovf2), t

            def interval(carry, _):
                carry, ts = plain_scan(carry, every - 1)
                carry, t_last = reneigh_step(carry)
                return carry, jnp.concatenate([ts, t_last[None]])

            # initial build
            x, v, nloc, halo, bl, br, nlist, ovf0 = (
                self._reneighbor_dev(x, v, nloc)
            )
            f = self._force_dev(x, nlist, halo, bl, br)
            carry = (x, v, f, nloc, halo, bl, br, nlist, ovf | ovf0)
            carry, temps = jax.lax.scan(interval, carry, None, length=n_int)
            x, v, f, nloc, halo, bl, br, nlist, ovf = carry
            return (
                x[None], v[None], f[None], nloc[None], halo.border_map[None],
                halo.shift[None], bl[None], br[None],
                nlist.neighbors[None], nlist.numneigh[None], ovf[None],
                temps.reshape(1, -1),
            )

        spec = P(AXIS)
        sharded = jax.shard_map(
            dev_body, mesh=self.mesh,
            in_specs=(spec,) * 11,
            out_specs=(spec,) * 11 + (P(AXIS),),
            check_vma=False,
        )
        return jax.jit(sharded)


    def _grow_and_reinit(self, state: Optional["DomainState"] = None,
                         xv=None):
        """Capacity-overflow retry (domain analogue of the single-chip
        engines' grow-and-retrace): bump every data-dependent capacity
        1.4x, recompute the row layout, re-init device state. When the
        failed run's final state is available, grow rcap to at least the
        OBSERVED maxima (engine._grow_caps lesson: a blind ladder from a
        tightly calibrated base can lose the race against a fast melt).
        xv: optional (x, v) global arrays to re-init from instead of
        t=0 — the chunk-boundary replay point (run_chunked)."""
        self.acap = (int(self.acap * 1.4) + 39) // 8 * 8
        self.gcap = int(self.gcap * 1.4) + 32
        self.bcap = int(self.bcap * 1.4) + 32
        self.migcap = int(self.migcap * 1.4) + 32
        self.maxneighs = (int(self.maxneighs * 1.4) + 7) // 8 * 8
        self.rcap = int(self.rcap * 1.6 + 7) // 8 * 8
        self.ccap = int(self.ccap * 1.5 + 7) // 8 * 8
        if state is not None and self._rowlist:
            nrmax = int(np.asarray(state.numneigh).max())
            self.rcap = max(self.rcap, (int(nrmax * 1.5) + 7) // 8 * 8)
        self.ucl += 2
        self.zw += 1
        self.ubr += 8
        self._fix_row_layout()
        self.grid = self.grid._replace(
            capacity=int(self.grid.capacity * 1.5 + 7) // 8 * 8
        )
        self._init_host_state(*(xv if xv is not None else self._xv_init))

    def _calibrate(self, ntimes: int, _retry: int = 4) -> None:
        """One-shot cap calibration on MELTED data (port of the
        single-chip rcap + melt calibration): run a throwaway
        reneighbor interval from t=0 at the generous initial caps, read
        the per-device row/candidate maxima from the probe's final
        rebuild, and re-set rcap/ccap/ucl/zw/ubr before the timed run.
        Only the rowlist path pays per-step for slack caps; planar
        skips."""
        if self._calibrated or not self._rowlist:
            return
        self._calibrated = True
        every = self.params.reneigh_every
        if ntimes < every:
            return
        state = self._run_raw(every, _retry=_retry).state
        # observe: one extra rebuild from the probe's final atoms, with
        # the build stats (post-bbox candidates, unit columns, z-span,
        # rows/cell) that drive the targeted caps
        spec = P(AXIS)

        def observe_dev(x, v, nloc):
            x, v, nloc = x[0], v[0], nloc[0]
            (_x, _v, _n, h, bl, br, nlist, _ovf, stats) = (
                self._reneighbor_dev(x, v, nloc, with_stats=True)
            )
            sent = _x.shape[0] - 1
            nb = jnp.maximum(
                jnp.sum(bl != sent), jnp.sum(br != sent)
            ).astype(jnp.int32)
            return (nlist.numneigh[None], stats[None],
                    h.nghost[None], nb[None])

        obs = jax.jit(jax.shard_map(
            observe_dev, mesh=self.mesh,
            in_specs=(spec, spec, spec), out_specs=(spec,) * 4,
            check_vma=False,
        ))
        nr, st, ng, nb = obs(state.x, state.v, state.nlocal)
        from mdbench_tpu.parallel.common import (
            apply_rowlist_caps,
            calibrated_block_cap,
        )

        apply_rowlist_caps(self, nr, st)
        self.gcap = calibrated_block_cap(int(np.asarray(ng).max()), 256)
        self.bcap = calibrated_block_cap(int(np.asarray(nb).max()), 128)
        self._fix_row_layout()
        self._init_host_state(*self._xv_init)

    def run(self, ntimes: Optional[int] = None, _retry: int = 6) -> DomainResult:
        ntimes = self.params.ntimes if ntimes is None else ntimes
        self._calibrate(ntimes)
        return self._run_raw(ntimes, _retry=_retry)

    def _run_raw(self, ntimes: int, _retry: int = 6) -> DomainResult:
        p = self.params
        dtype = p.dtype
        nd = self.ndev
        f0 = jnp.zeros((nd, self.acap, 3), dtype)
        hm0 = jnp.zeros((nd, self.gcap), jnp.int32)
        hs0 = jnp.zeros((nd, self.gcap, 3), dtype)
        bl0 = jnp.zeros((nd, self.bcap), jnp.int32)
        br0 = jnp.zeros((nd, self.bcap), jnp.int32)
        if self._rowlist:
            # neighbors/numneigh slots carry the packed row lists
            nb0 = jnp.zeros((nd, self.acap // 16, self.rcap), jnp.int32)
            nn0 = jnp.zeros((nd, self.acap // 16), jnp.int32)
        else:
            nb0 = jnp.zeros((nd, self.acap, self.maxneighs), jnp.int32)
            nn0 = jnp.zeros((nd, self.acap), jnp.int32)
        ovf0 = jnp.zeros((nd, 4), bool)

        run_fn = self._make_run_fn(ntimes)
        args = (self.x0, self.v0, f0, self.n0, hm0, hs0, bl0, br0,
                nb0, nn0, ovf0)
        # AOT-compile outside the timed region (same wall-clock protocol
        # as the single-chip engines: main.c times the step loop, not
        # the build)
        run_fn = run_fn.lower(*args).compile()
        # un-timed warm-up execution, as in the single-chip engines
        jax.block_until_ready(run_fn(*args))
        t0 = time.perf_counter()
        out = run_fn(*args)
        jax.block_until_ready(out)
        temps = out[-1]
        total = time.perf_counter() - t0
        state = DomainState(
            x=out[0], v=out[1], f=out[2], nlocal=out[3], halo_map=out[4],
            halo_shift=out[5], bmap_l=out[6], bmap_r=out[7],
            neighbors=out[8], numneigh=out[9], overflow=out[10],
        )
        if bool(np.asarray(state.overflow).any()):
            if _retry > 0:
                self._grow_and_reinit(state)
                return self._run_raw(ntimes, _retry=_retry - 1)
            raise RuntimeError(
                "domain capacity overflow: " + str(np.asarray(state.overflow))
            )
        # temps identical across devices (psum); take device 0's row
        return DomainResult(
            temps=np.asarray(temps[0]).reshape(-1), state=state,
            total_time=total,
        )

    def _global_from_dev(self, xs, vs, ns):
        """Reconstruct global (x, v) from the sharded device layout (a
        chunk-boundary restart point): per device, the local region is
        densely packed [0, nloc) in slab-frame coordinates, so the
        global arrays are the per-device locals shifted back by the
        slab origin, concatenated in device order. Row order within a
        device is preserved, so a replay's re-split reproduces the
        exact per-device atom order and the physics is bitwise the
        continuing run's (padding slots contribute exact zeros)."""
        xs, vs, ns = np.asarray(xs), np.asarray(vs), np.asarray(ns)
        xg, vg = [], []
        for d in range(self.ndev):
            n = int(ns[d])
            xd = xs[d, :n, :].astype(np.float64).copy()
            xd[:, 0] += d * self.slab_w
            xg.append(xd)
            vg.append(vs[d, :n, :].astype(np.float64))
        return np.concatenate(xg), np.concatenate(vg)

    def run_chunked(self, chunk: int, nchunks: int,
                    max_retries: int = 5) -> DomainResult:
        """Run in chunks with chunk-boundary overflow REPLAY (the domain
        twin of engine_cluster.run_chunked): a mid-run capacity overflow
        discards the failed chunk's output, grows capacities to at least
        the observed maxima, re-splits the boundary snapshot under the
        new caps, and replays the chunk — never restarts from t=0
        (reference semantics: the in-loop resize
        loop never aborts, verletlist/neighbor.c:247-262). chunk must be
        a multiple of reneigh_every (the run program rebuilds at chunk
        entry, which is a physics no-op at a rebuild boundary)."""
        p = self.params
        assert chunk % p.reneigh_every == 0
        self._calibrate(chunk)
        temps_all = []
        compiled = None
        retries = 0
        c = 0
        xin, vin, nin = self.x0, self.v0, self.n0
        t0 = time.perf_counter()
        while c < nchunks:
            if compiled is None:
                nd = self.ndev
                dtype = p.dtype
                f0 = jnp.zeros((nd, self.acap, 3), dtype)
                hm0 = jnp.zeros((nd, self.gcap), jnp.int32)
                hs0 = jnp.zeros((nd, self.gcap, 3), dtype)
                bl0 = jnp.zeros((nd, self.bcap), jnp.int32)
                br0 = jnp.zeros((nd, self.bcap), jnp.int32)
                if self._rowlist:
                    nb0 = jnp.zeros(
                        (nd, self.acap // 16, self.rcap), jnp.int32
                    )
                    nn0 = jnp.zeros((nd, self.acap // 16), jnp.int32)
                else:
                    nb0 = jnp.zeros(
                        (nd, self.acap, self.maxneighs), jnp.int32
                    )
                    nn0 = jnp.zeros((nd, self.acap), jnp.int32)
                ovf0 = jnp.zeros((nd, 4), bool)
                aux = (f0, hm0, hs0, bl0, br0, nb0, nn0, ovf0)
                compiled = self._make_run_fn(chunk).lower(
                    xin, vin, aux[0], nin, *aux[1:]
                ).compile()
            out = compiled(xin, vin, aux[0], nin, *aux[1:])
            ovf = np.asarray(out[10])
            if ovf.any():
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        "domain capacity overflow persisted in run_chunked"
                    )
                state = DomainState(
                    x=out[0], v=out[1], f=out[2], nlocal=out[3],
                    halo_map=out[4], halo_shift=out[5], bmap_l=out[6],
                    bmap_r=out[7], neighbors=out[8], numneigh=out[9],
                    overflow=out[10],
                )
                xg, vg = self._global_from_dev(xin, vin, nin)
                self._grow_and_reinit(state, xv=(xg, vg))
                xin, vin, nin = self.x0, self.v0, self.n0
                compiled = None  # shapes changed
                continue  # replay chunk c from the boundary snapshot
            temps_all.append(np.asarray(out[-1][0]).reshape(-1))
            xin, vin, nin = out[0], out[1], out[3]
            c += 1
        jax.block_until_ready(out)
        total = time.perf_counter() - t0
        state = DomainState(
            x=out[0], v=out[1], f=out[2], nlocal=out[3], halo_map=out[4],
            halo_shift=out[5], bmap_l=out[6], bmap_r=out[7],
            neighbors=out[8], numneigh=out[9], overflow=out[10],
        )
        return DomainResult(
            temps=np.concatenate(temps_all), state=state, total_time=total,
        )
