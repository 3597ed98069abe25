"""Multi-chip domain decomposition for the CLUSTER-PAIR scheme.

Completes the scheme x parallelism matrix: the flagship GROMACS-MxN
engine (engine_cluster.py) scaled over a device mesh the same way
verlet_domain.py scales the verlet scheme — 1-D x-slabs, everything
inside `shard_map`, cross-chip traffic = `lax.ppermute` only.

Per-device phases (each device owns [0, slab_w) x yprd x zprd in a
slab-local frame):

  reneighbor:  flatten clusters -> atom state (inverse-map gather) ->
               wrap y/z -> MIGRATE atoms over x faces (ppermute) ->
               re-chop into clusters on the slab grid -> LOCAL y/z
               cluster ghosts (setup_cluster_pbc with pbc=(0,1,1)) ->
               export j16 cluster PAIRS whose bbox is within cutneigh of
               an x face (locals + y/z ghosts, so corners ride along) ->
               ppermute row planes -> received rows become x-ghost
               clusters -> bin + group pair lists (ops/cluster machinery
               unchanged, slab-box grid)
  every step:  integrate local planes -> refresh local y/z ghost planes
               -> re-gather exported j16 rows, ppermute, refresh x-ghost
               rows -> cluster force kernel (the GPU exact-list kernel
               or its XLA twin, backend.resolve_kernel) -> integrate

The reference has no multi-node path at all (SURVEY §2.5); this is the
device-mesh design the serial ghost machinery implies
(clusterpair/pbc.c:144-299 at j-cluster granularity, generalized so a
"boundary image" can live on another chip)."""

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
from mdbench_tpu.ops.cluster import (
    bin_clusters,
    build_cluster_pairs,
    build_clusters,
    compute_bboxes,
    derive_ilists,
    make_cluster_grid,
    make_j16_bboxes,
    setup_cluster_pbc,
    update_cluster_pbc,
)
from mdbench_tpu.ops.pallas.lj_cluster import (
    lj_cluster_force_ilist_gpu,
    lj_cluster_force_xla,
    lj_cluster_force_xla_ilist,
)
from mdbench_tpu.state import SENTINEL_COORD
from mdbench_tpu.thermo import adjust_thermo, adjusted_dtforce, setup_thermo

AXIS = "x"
GROUP = 16


class ClusterDomainResult(NamedTuple):
    temps: np.ndarray
    nlocal: np.ndarray
    overflow: np.ndarray
    total_time: float
    x_flat: np.ndarray | None = None  # (ndev, acap+1, 3) final atoms
    v_flat: np.ndarray | None = None


class ClusterDomainSimulation:
    """Cluster-scheme MD over x-slabs + a ppermute halo exchange."""

    def __init__(self, params: Params, ndev: int,
                 x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None):
        self.params = params
        # EAM over the mesh: same exact-ilist two-pass force as the
        # single-chip cluster engine (ops/eam_cluster), with the
        # mid-force fp refresh extended by an x-border ppermute (the
        # cross-chip force_eam.c:117-120). Overrides land BEFORE the
        # slab geometry and lattice are derived.
        self.eam_tables = None
        self.eam_dev = None
        self.eam_poly = None
        if params.force_field != 0:  # FF_EAM
            from mdbench_tpu.models.eam_tables import (
                apply_eam_overrides,
                fit_eam_poly,
                load_eam,
            )

            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            if params.eam_eval == "spline":
                raise ValueError(
                    "cluster-scheme EAM is polynomial-evaluation only "
                    "(eam_eval=auto|poly); the spline parity axis runs "
                    "on the verlet scheme"
                )
            self.eam_tables = load_eam(params.eam_file)
            apply_eam_overrides(params, self.eam_tables)
            self.eam_poly = fit_eam_poly(self.eam_tables)
        self.ndev = ndev
        self.slab_w = params.xprd / ndev
        c = params.cutneigh
        assert self.slab_w >= c, "slab narrower than cutneigh"
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        self.slab_prd = np.array([self.slab_w, params.yprd, params.zprd])
        self.grid = make_cluster_grid(
            self.slab_prd, c, params.rho, GROUP
        )

        # capacities (per device): size the cluster window from the
        # ACTUAL t=0 per-device column occupancy (the single-chip
        # engine's bincount scheme) — a mean-based estimate compounds
        # two ceils per column into ~1.8x slack, and EVERY per-step
        # cost (plane copies, exchange payloads, kernel padding) scales
        # with ncl_pad. Migration drift is absorbed by the 1.18 margin + the
        # overflow-flag grow-and-retry backstop.
        per_dev = self.natoms / ndev
        sx, sy = self.grid.col_size
        ncx, ncy = self.grid.col_dims
        blk = GROUP
        n_cl_max = 0
        for d in range(ndev):
            m = (x[:, 0] >= d * self.slab_w) & (
                x[:, 0] < (d + 1) * self.slab_w
            )
            xs = x[m]
            cx = np.clip(
                ((xs[:, 0] - d * self.slab_w) / sx).astype(np.int64),
                0, ncx - 1,
            )
            cy = np.clip((xs[:, 1] / sy).astype(np.int64), 0, ncy - 1)
            counts = np.bincount(cx * ncy + cy, minlength=ncx * ncy)
            cl_col = np.ceil(np.ceil(counts / 8.0) / GROUP) * GROUP
            n_cl_max = max(n_cl_max, int(cl_col.sum()))
        self.ncl_pad = max(
            (int(n_cl_max * 1.18) + blk - 1) // blk * blk, blk
        )
        self.acap = int(math.ceil(per_dev * 1.12 / 8)) * 8 + 8
        # local y/z ghost cluster rows
        gfrac = (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd) - 1.0
        self.gcap_rows = (
            int(math.ceil(self.ncl_pad * gfrac * 1.8)) + 64 + 1
        ) // 2 * 2
        # x-face export: j16 pairs within c of a face, over locals+ghosts
        xfrac = (c + 2 * sx) / self.slab_w  # + bbox slop margin
        self.xcap16 = int(
            math.ceil((self.ncl_pad + self.gcap_rows) / 2 * xfrac * 1.8)
        ) + 32
        self.migcap = int(math.ceil(self.acap * 0.2)) + 32
        # per-group j-list capacity (same shape as engine_cluster)
        zspan = GROUP * 8 / (sx * sy * params.rho)
        vol = (
            (sx + 2 * c + sx) * (sy + 2 * c + sy) * (zspan + 2 * c + 2.0)
        )
        self.list_cap = max(
            32, int(math.ceil(vol * params.rho / 16.0 * 1.45 / 8.0)) * 8
        )
        # exact per-i-unit lists (share=2, the engine_cluster default)
        # unless the group-list kernel is asked for; no half lists here
        self._kmode, self.interpret = resolve_kernel(
            "cluster", params.precision, params.kernel,
            force_field=params.force_field,
        )
        self._ilist = self._kmode in ("ilist", "ilist_pl")
        self.ishare = 2
        self.icap = 48
        # one-shot melted-probe calibration state (port of the
        # single-chip _calibrate_list_cap)
        self._calibrated = False
        # total plane rows: locals + y/z ghosts + 2 x-ghost blocks + 2 sent
        self.nrows_cl = (
            self.ncl_pad + self.gcap_rows + 4 * self.xcap16 + 2
        )
        if self.eam_tables is not None:
            from mdbench_tpu.ops.eam import EamDevice

            self.eam_dev = EamDevice.from_tables(
                self.eam_tables, params.dtype
            )
        self.mesh = Mesh(np.array(jax.devices()[:ndev]), (AXIS,))
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    def _init_host_state(self, x, v):
        dtype = self.params.dtype
        slab = np.minimum(
            (x[:, 0] / self.slab_w).astype(np.int64), self.ndev - 1
        )
        xs = np.full((self.ndev, self.acap + 1, 3), SENTINEL_COORD,
                     np.float64)
        vs = np.zeros((self.ndev, self.acap, 3), np.float64)
        counts = np.zeros(self.ndev, np.int32)
        for d in range(self.ndev):
            idx = np.nonzero(slab == d)[0]
            n = len(idx)
            assert n <= self.acap, "initial slab overflow"
            xs[d, :n] = x[idx] - np.array([d * self.slab_w, 0.0, 0.0])
            vs[d, :n] = v[idx]
            counts[d] = n
        self.x0 = jnp.asarray(xs, dtype)
        self.v0 = jnp.asarray(vs, dtype)
        self.n0 = jnp.asarray(counts)

    # ---- per-device phases (inside shard_map) ------------------------------

    def _wrap_yz(self, x, nloc):
        p = self.params
        rows = jnp.arange(x.shape[0])[:, None]
        live = rows < nloc
        for d, prd in ((1, p.yprd), (2, p.zprd)):
            cc = x[:, d]
            cc = jnp.where(live[:, 0] & (cc < 0), cc + prd, cc)
            cc = jnp.where(live[:, 0] & (cc >= prd), cc - prd, cc)
            x = x.at[:, d].set(cc)
        return x

    def _migrate(self, x, v, nloc):
        """Atom migration over x faces (same protocol as
        verlet_domain._migrate)."""
        acap, migcap = self.acap, self.migcap
        dtype = x.dtype
        rows = jnp.arange(acap, dtype=jnp.int32)
        live = rows < nloc
        xl = x[:acap]
        go_l = live & (xl[:, 0] < 0.0)
        go_r = live & (xl[:, 0] >= self.slab_w)
        ovf_drift = jnp.any(
            live & ((xl[:, 0] < -self.slab_w)
                    | (xl[:, 0] >= 2 * self.slab_w))
        )
        stay = live & ~go_l & ~go_r

        def pack(mask, dx_shift):
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < migcap), pos, migcap)
            buf = jnp.full((migcap, 6), SENTINEL_COORD, dtype)
            payload = jnp.concatenate(
                [xl + jnp.asarray([dx_shift, 0, 0], dtype), v[:acap]],
                axis=1,
            )
            return buf.at[pos].set(payload, mode="drop"), cnt

        buf_l, cnt_l = pack(go_l, +self.slab_w)
        buf_r, cnt_r = pack(go_r, -self.slab_w)
        ovf = (cnt_l > migcap) | (cnt_r > migcap) | ovf_drift

        nd = self.ndev
        perm_r = [(i, (i + 1) % nd) for i in range(nd)]
        perm_l = [(i, (i - 1) % nd) for i in range(nd)]
        recv_from_right = jax.lax.ppermute(buf_l, AXIS, perm_l)
        recv_from_left = jax.lax.ppermute(buf_r, AXIS, perm_r)

        pos = jnp.cumsum(stay) - 1
        n_stay = jnp.sum(stay).astype(jnp.int32)
        pos = jnp.where(stay, pos, acap)
        x2 = jnp.full((acap + 1, 3), SENTINEL_COORD, dtype)
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
        return x2, v2, n2, ovf | (n2 > acap)

    def _export_maps(self, bbox):
        """j16 ids (over locals + y/z ghosts) whose bbox is within
        cutneigh of an x face."""
        c = self.params.cutneigh
        n16scan = (self.ncl_pad + self.gcap_rows) // 2
        bb16 = make_j16_bboxes(bbox[: self.ncl_pad + self.gcap_rows])
        live = bb16[:, 0] < SENTINEL_COORD * 0.25
        exp_l = live & (bb16[:, 0] < c)
        exp_r = live & (bb16[:, 1] >= self.slab_w - c)
        ids = jnp.arange(n16scan, dtype=jnp.int32)
        sent16 = self.nrows_cl // 2 - 1

        def pack(mask):
            pos = jnp.cumsum(mask) - 1
            cnt = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(mask & (pos < self.xcap16), pos, self.xcap16)
            m = jnp.full((self.xcap16,), sent16, jnp.int32)
            return m.at[pos].set(ids, mode="drop"), cnt

        ml, cl = pack(exp_l)
        mr, cr = pack(exp_r)
        return ml, mr, (cl > self.xcap16) | (cr > self.xcap16)

    def _exchange_rows(self, planes, map_l, map_r, with_bbox):
        """Gather exported j16 row pairs, shift x, ppermute, write the
        x-ghost blocks. planes = Clusters pytree."""
        dtype = planes.xc.dtype
        nd = self.ndev
        row_map_l = (2 * map_l[:, None]
                     + jnp.arange(2, dtype=jnp.int32)[None, :]).reshape(-1)
        row_map_r = (2 * map_r[:, None]
                     + jnp.arange(2, dtype=jnp.int32)[None, :]).reshape(-1)

        def payload(row_map, xshift):
            parts = [
                planes.xc[row_map] + xshift,
                planes.yc[row_map],
                planes.zc[row_map],
                planes.tc[row_map],
            ]
            if with_bbox:
                bb = planes.bbox[row_map]
                bb = bb.at[:, 0:2].add(xshift)
                parts.append(bb)
            return jnp.concatenate(parts, axis=1)  # (rows, 32 or 40)

        send_l = payload(row_map_l, jnp.asarray(self.slab_w, dtype))
        send_r = payload(row_map_r, jnp.asarray(-self.slab_w, dtype))
        perm_r = [(i, (i + 1) % nd) for i in range(nd)]
        perm_l = [(i, (i - 1) % nd) for i in range(nd)]
        from_right = jax.lax.ppermute(send_l, AXIS, perm_l)
        from_left = jax.lax.ppermute(send_r, AXIS, perm_r)

        g0 = self.ncl_pad + self.gcap_rows
        nxr = 2 * self.xcap16

        def write(planes, rec, base):
            xc = planes.xc.at[base : base + nxr].set(rec[:, 0:8])
            yc = planes.yc.at[base : base + nxr].set(rec[:, 8:16])
            zc = planes.zc.at[base : base + nxr].set(rec[:, 16:24])
            tc = planes.tc.at[base : base + nxr].set(rec[:, 24:32])
            if with_bbox:
                bbox = planes.bbox.at[base : base + nxr].set(rec[:, 32:40])
            else:
                bbox = planes.bbox
            return planes._replace(xc=xc, yc=yc, zc=zc, tc=tc, bbox=bbox)

        planes = write(planes, from_left, g0)
        planes = write(planes, from_right, g0 + nxr)
        return planes

    def _reneighbor_dev(self, x_flat, v_flat, nloc):
        p = self.params
        x_flat = self._wrap_yz(x_flat, nloc)
        x_flat, v_flat, nloc, ovf_m = self._migrate(x_flat, v_flat, nloc)
        # re-chop into clusters; ghost capacity = y/z ghosts + x blocks
        ghost_rows = self.gcap_rows + 4 * self.xcap16
        clusters, ovf_c = build_clusters(
            self.grid, x_flat, self.acap, self.ncl_pad, ghost_rows,
            group=GROUP,
        )
        aid = clusters.atom_id
        valid = aid >= 0
        a = jnp.clip(aid, 0, self.acap - 1)
        zeros = jnp.zeros_like(clusters.xc[: self.ncl_pad])
        vxc = jnp.where(valid, v_flat[a, 0], zeros)
        vyc = jnp.where(valid, v_flat[a, 1], zeros)
        vzc = jnp.where(valid, v_flat[a, 2], zeros)

        # local y/z cluster ghosts on the slab box
        halo = setup_cluster_pbc(
            clusters, self.ncl_pad, self.ncl_pad, self.gcap_rows,
            self.slab_prd, (0, p.pbc_y, p.pbc_z), p.cutneigh,
        )
        clusters = update_cluster_pbc(
            clusters, halo, self.ncl_pad, update_bbox=True
        )
        # x-face exports + cross-chip ghost rows (bboxes ride along)
        map_l, map_r, ovf_x = self._export_maps(clusters.bbox)
        clusters = self._exchange_rows(clusters, map_l, map_r, True)

        bbox16 = make_j16_bboxes(clusters.bbox)
        cells, bb_cells, (ovf_b, ovf_z) = bin_clusters(self.grid, bbox16)
        pairs = build_cluster_pairs(
            self.grid, cells, bb_cells, clusters.bbox, self.ncl_pad,
            GROUP, self.list_cap, need_ranges=not self._ilist,
        )
        if self._ilist:
            pairs = derive_ilists(
                clusters, pairs, self.ncl_pad, GROUP, p.cutneigh,
                self.icap, share=self.ishare,
            )
        iovf = pairs.iovf if pairs.iovf is not None else jnp.asarray(False)
        ovf = jnp.stack([
            ovf_m, ovf_c, halo.overflow, ovf_x, ovf_b, ovf_z,
            pairs.overflow[0], pairs.overflow[1], iovf,
        ])
        # nloc comes from migration: build_clusters treats the whole
        # acap window as "local" (sentinel padding rows become inert
        # sentinel cluster slots), so atom_id cannot be used to count
        return clusters, (vxc, vyc, vzc), halo, (map_l, map_r), pairs, nloc, ovf

    def _rebuild_cheap_dev(self, cl, nloc):
        """List rebuild WITHOUT re-chop or migration — the port of
        engine_cluster._reneigh_step_cheap's rebuild to the slab frame.
        Cluster membership is kept between resort boundaries, so the
        flatten + migrate + re-chop + velocity-regather (the bulk of
        the full domain rebuild) is skipped; only
        ghosts, exports, bins, pair lists, and exact lists are rebuilt
        from CURRENT coordinates. y/z wrap is j16-PAIR-granular (the
        single engine's invariant); x NEVER wraps here — clusters that
        drift past a slab face stay owned until the next full rebuild's
        migration, exactly like the single engine's atoms between wrap
        points, and the bbox-driven exports/bins cover them."""
        p = self.params
        npad = self.ncl_pad
        dtype = cl.xc.dtype
        prd = jnp.asarray(self.slab_prd, dtype)
        pbc_on = jnp.asarray([0.0, p.pbc_y, p.pbc_z], dtype)
        bbox_l = compute_bboxes(cl.xc[:npad], cl.yc[:npad], cl.zc[:npad])
        bb16_l = make_j16_bboxes(bbox_l)

        def wrap_shift(lo, hi, L, on):
            mid = 0.5 * (lo + hi)
            return jnp.repeat(-L * jnp.floor(mid / L) * on, 2)

        shx = wrap_shift(bb16_l[:, 0], bb16_l[:, 1], prd[0], pbc_on[0])
        shy = wrap_shift(bb16_l[:, 2], bb16_l[:, 3], prd[1], pbc_on[1])
        shz = wrap_shift(bb16_l[:, 4], bb16_l[:, 5], prd[2], pbc_on[2])
        xc = cl.xc.at[:npad].add(shx[:, None])
        yc = cl.yc.at[:npad].add(shy[:, None])
        zc = cl.zc.at[:npad].add(shz[:, None])
        sh8 = jnp.stack(
            [shx, shx, shy, shy, shz, shz,
             jnp.zeros_like(shx), jnp.zeros_like(shx)], axis=1
        )
        bbox = cl.bbox.at[:npad].set(bbox_l + sh8)
        cl = cl._replace(xc=xc, yc=yc, zc=zc, bbox=bbox)

        halo = setup_cluster_pbc(
            cl, npad, npad, self.gcap_rows, self.slab_prd,
            (0, p.pbc_y, p.pbc_z), p.cutneigh,
        )
        cl = update_cluster_pbc(cl, halo, npad, update_bbox=True)
        map_l, map_r, ovf_x = self._export_maps(cl.bbox)
        cl = self._exchange_rows(cl, map_l, map_r, True)
        bbox16 = make_j16_bboxes(cl.bbox)
        cells, bb_cells, (ovf_b, ovf_z) = bin_clusters(self.grid, bbox16)
        pairs = build_cluster_pairs(
            self.grid, cells, bb_cells, cl.bbox, npad, GROUP,
            self.list_cap, need_ranges=not self._ilist,
        )
        if self._ilist:
            pairs = derive_ilists(
                cl, pairs, npad, GROUP, p.cutneigh, self.icap,
                share=self.ishare,
            )
        iovf = pairs.iovf if pairs.iovf is not None else jnp.asarray(False)
        f_ = jnp.asarray(False)
        ovf = jnp.stack([
            f_, f_, halo.overflow, ovf_x, ovf_b, ovf_z,
            pairs.overflow[0], pairs.overflow[1], iovf,
        ])
        return cl, halo, (map_l, map_r), pairs, ovf

    def _flatten_dev(self, clusters, vxc, vyc, vzc):
        inv = clusters.inv_map
        dtype = clusters.xc.dtype

        def gath(px, py, pz):
            out = jnp.full((self.acap + 1, 3), SENTINEL_COORD, dtype)
            vals = jnp.stack(
                [px[: self.ncl_pad].reshape(-1)[inv],
                 py[: self.ncl_pad].reshape(-1)[inv],
                 pz[: self.ncl_pad].reshape(-1)[inv]],
                axis=1,
            )
            return out.at[: self.acap].set(vals)

        x_flat = gath(clusters.xc, clusters.yc, clusters.zc)
        v_flat = gath(vxc, vyc, vzc)[: self.acap]
        return x_flat, v_flat

    def _force_dev(self, clusters, pairs, halo, maps):
        p = self.params
        cutsq = p.cutforce**2
        if self.eam_dev is not None:
            nd = self.ndev

            def fp_exchange(fp_plane):
                # local y/z ghost fp from owners, then x-border fp over
                # the mesh — same row maps and write layout as the
                # coordinate exchange (_exchange_rows), no shift (fp is
                # translation invariant). Mirrors force_eam.c:117-120
                # across chips.
                from mdbench_tpu.ops.eam_cluster import _fp_ghost_refresh

                fp_plane = _fp_ghost_refresh(
                    fp_plane, halo.border_map, self.ncl_pad
                )
                map_l, map_r = maps
                rm_l = (2 * map_l[:, None]
                        + jnp.arange(2, dtype=jnp.int32)[None, :]
                        ).reshape(-1)
                rm_r = (2 * map_r[:, None]
                        + jnp.arange(2, dtype=jnp.int32)[None, :]
                        ).reshape(-1)
                send_l = fp_plane[rm_l]
                send_r = fp_plane[rm_r]
                perm_r = [(i, (i + 1) % nd) for i in range(nd)]
                perm_l = [(i, (i - 1) % nd) for i in range(nd)]
                from_right = jax.lax.ppermute(send_l, AXIS, perm_l)
                from_left = jax.lax.ppermute(send_r, AXIS, perm_r)
                g0 = self.ncl_pad + self.gcap_rows
                nxr = 2 * self.xcap16
                fp_plane = fp_plane.at[g0 : g0 + nxr].set(from_left)
                fp_plane = fp_plane.at[g0 + nxr : g0 + 2 * nxr].set(
                    from_right
                )
                return fp_plane

            from mdbench_tpu.ops.eam_cluster import eam_cluster_force_xla

            fx, fy, fz, _fp = eam_cluster_force_xla(
                clusters.xc, clusters.yc, clusters.zc, pairs.ijlist,
                halo.border_map, self.ncl_pad, cutsq, self.eam_dev,
                self.eam_poly, share=self.ishare,
                fp_exchange=fp_exchange,
            )
            return fx, fy, fz
        if self._kmode == "ilist_pl":
            return lj_cluster_force_ilist_gpu(
                clusters.xc, clusters.yc, clusters.zc, pairs.ijlist,
                pairs.nji, self.ncl_pad, cutsq, p.sigma6, p.epsilon,
                share=self.ishare, interpret=self.interpret,
            )
        if self._ilist:
            return lj_cluster_force_xla_ilist(
                clusters.xc, clusters.yc, clusters.zc, pairs.ijlist,
                self.ncl_pad, cutsq, p.sigma6, p.epsilon,
                share=self.ishare,
            )
        return lj_cluster_force_xla(
            clusters.xc, clusters.yc, clusters.zc, pairs.jlist,
            self.ncl_pad, GROUP, cutsq, p.sigma6, p.epsilon,
        )

    # ---- the sharded run ---------------------------------------------------

    def _make_run_fn(self, ntimes: int):
        p = self.params
        dt, dtf = p.dt, self.dtforce
        every = p.reneigh_every
        n_int = max(ntimes // every, 1)
        mass, scales = p.mass, self.scales

        def dev_body(x, v, nloc):
            x, v, nloc = x[0], v[0], nloc[0]

            def thermo(vxc, vyc, vzc):
                vsq = (
                    jnp.sum(vxc * vxc) + jnp.sum(vyc * vyc)
                    + jnp.sum(vzc * vzc)
                ) * mass
                return jax.lax.psum(vsq, AXIS) * scales.t_scale

            def plain_scan(carry, n):
                """n plain steps carrying ONLY the nine mutable planes —
                the halo/maps/pairs tables are rebuild-invariant, and
                keeping them in the scan carry makes XLA thread (and
                copy) the list arrays through every step (the same lean-
                carry lesson as engine_cluster._plain_scan)."""
                cl0, vxc, vyc, vzc, fxc, fyc, fzc, nloc, halo, maps, pairs, ovf = carry

                def body(mv, _):
                    xc, yc, zc, vx, vy, vz, fx, fy, fz = mv
                    vx = vx + dtf * fx
                    vy = vy + dtf * fy
                    vz = vz + dtf * fz
                    xc = xc.at[: self.ncl_pad].add(dt * vx)
                    yc = yc.at[: self.ncl_pad].add(dt * vy)
                    zc = zc.at[: self.ncl_pad].add(dt * vz)
                    cl = cl0._replace(xc=xc, yc=yc, zc=zc)
                    cl = update_cluster_pbc(cl, halo, self.ncl_pad, False)
                    cl = self._exchange_rows(cl, maps[0], maps[1], False)
                    fx, fy, fz = self._force_dev(cl, pairs, halo, maps)
                    vx = vx + dtf * fx
                    vy = vy + dtf * fy
                    vz = vz + dtf * fz
                    # per-step thermo only when asked: it is a psum'd
                    # cross-chip collective in the hot loop otherwise
                    if p.dense_thermo:
                        t = thermo(vx, vy, vz)
                    else:
                        t = jnp.zeros((), vx.dtype)
                    return (cl.xc, cl.yc, cl.zc, vx, vy, vz, fx, fy, fz), t

                mv0 = (cl0.xc, cl0.yc, cl0.zc, vxc, vyc, vzc, fxc, fyc, fzc)
                mv, ts = jax.lax.scan(body, mv0, None, length=n)
                xc, yc, zc, vxc, vyc, vzc, fxc, fyc, fzc = mv
                carry = (
                    cl0._replace(xc=xc, yc=yc, zc=zc), vxc, vyc, vzc,
                    fxc, fyc, fzc, nloc, halo, maps, pairs, ovf,
                )
                return carry, ts

            def reneigh_step(carry, full):
                cl, vxc, vyc, vzc, fxc, fyc, fzc, nloc, halo, maps, pairs, ovf = carry
                vxc = vxc + dtf * fxc
                vyc = vyc + dtf * fyc
                vzc = vzc + dtf * fzc
                xc = cl.xc.at[: self.ncl_pad].add(dt * vxc)
                yc = cl.yc.at[: self.ncl_pad].add(dt * vyc)
                zc = cl.zc.at[: self.ncl_pad].add(dt * vzc)
                cl = cl._replace(xc=xc, yc=yc, zc=zc)
                if full:
                    x_flat, v_flat = self._flatten_dev(cl, vxc, vyc, vzc)
                    cl, (vxc, vyc, vzc), halo, maps, pairs, nloc, ovf2 = (
                        self._reneighbor_dev(x_flat, v_flat, nloc)
                    )
                else:
                    cl, halo, maps, pairs, ovf2 = (
                        self._rebuild_cheap_dev(cl, nloc)
                    )
                fxc, fyc, fzc = self._force_dev(cl, pairs, halo, maps)
                vxc = vxc + dtf * fxc
                vyc = vyc + dtf * fyc
                vzc = vzc + dtf * fzc
                t = thermo(vxc, vyc, vzc)
                return (
                    cl, vxc, vyc, vzc, fxc, fyc, fzc, nloc, halo, maps,
                    pairs, ovf | ovf2,
                ), t

            def interval(carry, full):
                carry, ts = plain_scan(carry, every - 1)
                carry, t_last = reneigh_step(carry, full)
                return carry, jnp.concatenate([ts, t_last[None]])

            cl, (vxc, vyc, vzc), halo, maps, pairs, nloc, ovf0 = (
                self._reneighbor_dev(x, v, nloc)
            )
            fxc, fyc, fzc = self._force_dev(cl, pairs, halo, maps)
            carry = (
                cl, vxc, vyc, vzc, fxc, fyc, fzc, nloc, halo, maps,
                pairs, ovf0,
            )
            # full-vs-cheap rebuild cadence (engine_cluster._make_run_fn
            # segment scheme): the full re-chop + MIGRATION fires only
            # at resort_every boundaries; every other rebuild is the
            # cheap fixed-membership one. Consecutive same-kind
            # intervals roll into one lax.scan.
            resort = self.params.resort_every if self.params.sort_atoms else 0
            full_flags = [
                bool(resort <= 0 or ((i + 1) * every) % resort == 0)
                for i in range(n_int)
            ]
            segments = []
            for fl in full_flags:
                if segments and segments[-1][0] == fl:
                    segments[-1][1] += 1
                else:
                    segments.append([fl, 1])
            tparts = []
            for fl, count in segments:
                carry, tps = jax.lax.scan(
                    lambda s, _, fl=fl: interval(s, fl), carry, None,
                    length=count,
                )
                tparts.append(tps.reshape(-1))
            temps = jnp.concatenate(tparts)[None, :]
            # final flat atoms ride out so the calibration probe (and
            # future checkpoint hooks) can observe the melted state
            xf, vf = self._flatten_dev(carry[0], carry[1], carry[2], carry[3])
            return (
                carry[7][None],  # nloc
                carry[11][None],  # overflow
                temps.reshape(1, -1),
                xf[None],
                vf[None],
            )

        spec = P(AXIS)
        sharded = jax.shard_map(
            dev_body, mesh=self.mesh,
            in_specs=(spec, spec, spec),
            out_specs=(spec,) * 5,
            check_vma=False,
        )
        return jax.jit(sharded)


    def _grow_and_reinit(self, flags=None):
        """Targeted capacity growth from the overflow-flag vector
        [migrate, clusters, halo, x-export, bin_cap, z_ext, pairs_nj,
        pairs_coverage, ilist] — the single-chip engine's _grow scheme.
        Structural flags (bin capacity / z extent / pair coverage) must
        regrow the GRID slop factors, which no array capacity fixes (a
        blind ladder would loop forever on a zspan flag)."""
        if flags is None:
            flags = np.ones(9, bool)
        blk = GROUP
        if flags[0]:
            self.migcap = int(self.migcap * 1.4) + 32
            self.acap = (int(self.acap * 1.4) + 39) // 8 * 8
        if flags[1]:
            self.ncl_pad = (int(self.ncl_pad * 1.3) + blk) // blk * blk
        if flags[2]:
            self.gcap_rows = (int(self.gcap_rows * 1.4) + 33) // 2 * 2
        if flags[3]:
            self.xcap16 = int(self.xcap16 * 1.4) + 32
        if flags[6]:
            self.list_cap = (int(self.list_cap * 1.4) + 7) // 8 * 8
        if flags[8]:
            self.icap = (int(self.icap * 1.5) + 7) // 8 * 8
        if flags[4] or flags[5] or flags[7]:
            self.grid = make_cluster_grid(
                self.slab_prd, self.params.cutneigh, self.params.rho,
                GROUP,
                bin_capacity=(
                    int(self.grid.bin_capacity * 1.5 + 3) // 4 * 4
                    if flags[4] else self.grid.bin_capacity
                ),
                slop_z=(
                    self.grid.slop_z * 1.5 if flags[5] else self.grid.slop_z
                ),
                slop_xy=(
                    self.grid.slop_xy * 1.5 if flags[5] else self.grid.slop_xy
                ),
                zspan_factor=(
                    self.grid.zspan_factor * 1.3
                    if flags[7] else self.grid.zspan_factor
                ),
                drift_xy=(
                    self.grid.drift_xy * 1.5
                    if flags[7] else self.grid.drift_xy
                ),
            )
        self.nrows_cl = (
            self.ncl_pad + self.gcap_rows + 4 * self.xcap16 + 2
        )
        self._init_host_state(*self._xv_init)

    def _calibrate(self, ntimes: int, _retry: int = 4) -> None:
        """One-shot list-capacity calibration on MELTED data (port of
        the single-chip _calibrate_list_cap): run a throwaway reneighbor
        interval from t=0, re-derive the lists from the probe's final
        atoms, and set icap/list_cap from the observed maxima."""
        if self._calibrated or not self._ilist:
            return
        self._calibrated = True
        every = self.params.reneigh_every
        if ntimes < every:
            return
        out = self._run_raw(every, _retry=_retry)
        spec = P(AXIS)

        def observe_dev(x, v, nloc):
            x, v, nloc = x[0], v[0], nloc[0]
            cl_, _v3, halo_, maps_, pairs, _n, _ovf = (
                self._reneighbor_dev(x, v, nloc)
            )
            sent16 = self.nrows_cl // 2 - 1
            nx16 = jnp.maximum(
                jnp.sum(maps_[0] != sent16), jnp.sum(maps_[1] != sent16)
            ).astype(jnp.int32)
            return (pairs.nji[None], pairs.nj[None],
                    halo_.nghost[None], nx16[None])

        obs = jax.jit(jax.shard_map(
            observe_dev, mesh=self.mesh,
            in_specs=(spec, spec, spec), out_specs=(spec,) * 4,
            check_vma=False,
        ))
        nji, nj, ng16, nx16 = obs(
            jnp.asarray(out.x_flat), jnp.asarray(out.v_flat),
            jnp.asarray(out.nlocal),
        )
        nji = np.asarray(nji)  # (ndev, units)
        nj = np.asarray(nj)
        # ghost/export caps from observed melted counts (single-chip
        # ghost-cap lesson): update_cluster_pbc + _exchange_rows
        # gather/write the FULL padded blocks every step
        self.gcap_rows = max(
            (int(np.asarray(ng16).max() * 2 * 1.25) + 15) // 16 * 16, 64
        )
        self.xcap16 = max(int(np.asarray(nx16).max() * 1.25) + 16, 64)
        # wider margins than the single-chip engine: the probe melts only
        # one interval, the timed run drifts for ntimes
        # margins sized for the CHEAP-rebuild era: clusters drift for a
        # full resort_every interval (not just reneigh_every) before a
        # re-chop, so the probe's one-interval maxima understate the
        # steady state more than on the single-chip engine (a mid-run
        # overflow costs a full retried run)
        self.icap = max(
            (int(nji.max() * 1.35) + 2 + 7) // 8 * 8, 16
        )
        self.list_cap = max((int(nj.max() * 1.45) + 7) // 8 * 8, 32)
        self.nrows_cl = (
            self.ncl_pad + self.gcap_rows + 4 * self.xcap16 + 2
        )
        self._init_host_state(*self._xv_init)

    def run(self, ntimes: Optional[int] = None,
            _retry: int = 6) -> ClusterDomainResult:
        ntimes = self.params.ntimes if ntimes is None else ntimes
        self._calibrate(ntimes)
        return self._run_raw(ntimes, _retry=_retry)

    def _run_raw(self, ntimes: int, _retry: int = 6) -> ClusterDomainResult:
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
        nloc, ovf, temps, xf, vf = out
        nloc = np.asarray(nloc)
        ovf = np.asarray(ovf)
        if ovf.any():
            if _retry > 0:
                # ovf is (ndev, 9): OR across devices -> targeted growth
                self._grow_and_reinit(ovf.reshape(-1, ovf.shape[-1]).any(0))
                return self._run_raw(ntimes, _retry=_retry - 1)
            raise RuntimeError(
                "cluster-domain capacity overflow: flags "
                + str(ovf.reshape(-1, ovf.shape[-1]).any(0))
            )
        return ClusterDomainResult(
            temps=np.asarray(temps[0]).reshape(-1), nlocal=nloc,
            overflow=ovf, total_time=total, x_flat=np.asarray(xf),
            v_flat=np.asarray(vf),
        )
