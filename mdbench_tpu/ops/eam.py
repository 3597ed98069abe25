"""EAM force over Verlet neighbor lists — two passes with a ghost-fp
exchange between them (reference: src/verletlist/force_eam.c:20-231).

Pass 1: per-atom embedding density rho_i from the rhor spline, then
fp_i = dF/drho from the frho spline. Ghost fp values are copied through
border_map (the dependency that forces two passes, force_eam.c:117-120).
Pass 2: pair forces from rhor' / z2r splines:
  phi = z2/r; psip = fp_i*rhoip + fp_j*rhoip + phip; F = -psip/r.

Device shape: spline lookups are row gathers of (n+1, 7) tables by the
(N, K) grid index; all arithmetic is planar (N, K). The clusterpair
reference never finished EAM (force_eam.c is stubbed out, SURVEY §2.3);
here EAM runs on the verlet path, matching that reality.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class EamDevice(NamedTuple):
    """Device-resident spline tables.

    rhor and z2r are indexed by the SAME r-grid index m, so the force
    path gathers them as one packed (nr+1, 14) row table: one gather
    per pair instead of two."""

    rhor: jnp.ndarray  # (nr+1, 7)
    frho: jnp.ndarray  # (nrho+1, 7)
    z2r: jnp.ndarray  # (nr+1, 7)
    rdr: float
    rdrho: float
    nr: int
    nrho: int

    @classmethod
    def from_tables(cls, t, dtype) -> "EamDevice":
        """Device-resident splines from host EamTables (the one
        construction every engine shares)."""
        return cls(
            rhor=jnp.asarray(t.rhor_spline, dtype),
            frho=jnp.asarray(t.frho_spline, dtype),
            z2r=jnp.asarray(t.z2r_spline, dtype),
            rdr=t.rdr, rdrho=t.rdrho, nr=t.nr, nrho=t.nrho,
        )

    @property
    def rz_packed(self) -> jnp.ndarray:  # (nr+1, 14) [rhor | z2r]
        return jnp.concatenate([self.rhor, self.z2r], axis=1)


def use_poly_eval(params) -> bool:
    """Resolve the eam_eval axis: "poly" forces the gather-free
    polynomial pair evaluation, "spline" forces the reference-exact
    gathered splines, "auto" = poly on accelerator SP runs (the fast
    axis), spline otherwise (the parity axis)."""
    from mdbench_tpu.backend import resolve_eam_eval

    return resolve_eam_eval(params.eam_eval, params.precision) == "poly"


def _grid_index(r_or_rho, rd, n):
    """p = x*rd + 1; m = clamp(floor(p)); fractional remainder
    (reference: force_eam.c:74-79, 100-105)."""
    p = r_or_rho * rd + 1.0
    m = jnp.floor(p).astype(jnp.int32)
    m = jnp.clip(m, 1, n - 1)
    frac = jnp.minimum(p - m, 1.0)
    return m, frac


def compute_force_eam(
    x: jnp.ndarray,
    neighbors: jnp.ndarray,
    numneigh: jnp.ndarray,
    border_map: jnp.ndarray,
    nlocal: int,
    nlocal_pad: int,
    cutforcesq: float,
    eam: EamDevice,
    fp_exchange=None,
):
    """Returns (forces (nlocal_pad, 3), fp (nrows,)).

    fp_exchange(fp) -> fp: fills GHOST rows of the embedding-derivative
    array between the two passes. Default = the single-chip border_map
    gather (force_eam.c:117-120); the multi-chip domain engine passes a
    closure that additionally ppermutes boundary fp values over the
    device mesh (the cross-chip analogue of the same copy)."""
    k = neighbors.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = lane < numneigh[:, None]

    xj = x[neighbors]
    xi = x[:nlocal_pad]
    dx = xi[:, 0, None] - xj[:, :, 0]
    dy = xi[:, 1, None] - xj[:, :, 1]
    dz = xi[:, 2, None] - xj[:, :, 2]
    rsq = dx * dx + dy * dy + dz * dz
    mask = valid & (rsq < cutforcesq)
    r = jnp.sqrt(jnp.where(mask, rsq, 1.0))

    m, p = _grid_index(r, eam.rdr, eam.nr)

    # ONE packed row gather serves both passes: rhor and z2r share the
    # index m, so one 14-wide [rhor|z2r] row replaces two. The
    # four spline values are derived immediately so only (N, K) planes
    # stay live across the fp exchange, not the (N, K, 14) rows.
    rows = eam.rz_packed[m]  # (N, K, 14)
    rs = rows[..., 0:7]
    zs = rows[..., 7:14]
    dens = ((rs[..., 3] * p + rs[..., 4]) * p + rs[..., 5]) * p + rs[..., 6]
    rhoip = (rs[..., 0] * p + rs[..., 1]) * p + rs[..., 2]
    z2p = (zs[..., 0] * p + zs[..., 1]) * p + zs[..., 2]
    z2 = ((zs[..., 3] * p + zs[..., 4]) * p + zs[..., 5]) * p + zs[..., 6]

    # pass 1: embedding density (force_eam.c:60-90)
    rhoi = jnp.sum(jnp.where(mask, dens, 0.0), axis=1)  # (nlocal_pad,)

    mf, pf = _grid_index(rhoi, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # (nlocal_pad, 7)
    fp_local = (fs[:, 0] * pf + fs[:, 1]) * pf + fs[:, 2]

    # ghost fp through border_map (force_eam.c:117-120)
    nrows = x.shape[0]
    fp = jnp.zeros((nrows,), x.dtype)
    fp = fp.at[:nlocal_pad].set(fp_local)
    if fp_exchange is None:
        gcap = border_map.shape[0]
        fp = fp.at[nlocal_pad : nlocal_pad + gcap].set(fp[border_map])
    else:
        fp = fp_exchange(fp)

    # pass 2: pair forces (force_eam.c:122-227)
    recip = 1.0 / r
    phi = z2 * recip
    phip = z2p * recip - phi * recip
    fpj = fp[neighbors]
    psip = fp_local[:, None] * rhoip + fpj * rhoip + phip
    fpair = jnp.where(mask, -psip * recip, 0.0)

    fx = jnp.sum(dx * fpair, axis=1)
    fy = jnp.sum(dy * fpair, axis=1)
    fz = jnp.sum(dz * fpair, axis=1)
    return jnp.stack([fx, fy, fz], axis=1), fp


def _horner(coefs, t):
    """Power-basis Horner with STATIC Python-float coefficients —
    XLA folds them into the fused elementwise chain; zero operands,
    zero gathers. `coefs` ascending (numpy polynomial convention)."""
    acc = jnp.full_like(t, float(coefs[-1]))
    for c in coefs[-2::-1]:
        acc = acc * t + float(c)
    return acc


def compute_force_eam_poly(
    x: jnp.ndarray,
    neighbors: jnp.ndarray,
    numneigh: jnp.ndarray,
    border_map: jnp.ndarray,
    nlocal: int,
    nlocal_pad: int,
    cutforcesq: float,
    eam: EamDevice,
    poly,  # models.eam_tables.EamPoly (host-side, coefficients static)
    fp_exchange=None,
):
    """Gather-free-per-pair EAM force twin of compute_force_eam: the
    rhor/z2r spline lookups (a per-pair row gather) are replaced by
    global polynomial
    evaluation in-register (models/eam_tables.fit_eam_poly):

      pass 1: rho_i = sum dens(r_ij)
      pass 2: fpair = -((fp_i + fp_j) * g1(r) + g2(r))

    identical force law (the 1/r chain is folded into g1/g2), ~1e-6
    function accuracy — the SP accelerator axis. frho (per-ATOM, one
    cheap gather) stays on the exact spline. Same two-pass structure
    and fp_exchange contract as compute_force_eam
    (reference force_eam.c:20-231)."""
    k = neighbors.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = lane < numneigh[:, None]

    xj = x[neighbors]
    xi = x[:nlocal_pad]
    dx = xi[:, 0, None] - xj[:, :, 0]
    dy = xi[:, 1, None] - xj[:, :, 1]
    dz = xi[:, 2, None] - xj[:, :, 2]
    rsq = dx * dx + dy * dy + dz * dz
    mask = valid & (rsq < cutforcesq)
    r = jnp.sqrt(jnp.where(mask, rsq, 1.0))
    # mapped fit variable; clamp covers r < lo (unphysical overlap) and
    # the masked-out filler r=1.0
    t = jnp.clip((r - poly.mid) * poly.iscale, -1.0, 1.0)

    # pass 1: embedding density (force_eam.c:60-90)
    rhoi = jnp.sum(jnp.where(mask, _horner(poly.dens, t), 0.0), axis=1)

    mf, pf = _grid_index(rhoi, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # per-atom row gather — cheap, kept exact
    fp_local = (fs[:, 0] * pf + fs[:, 1]) * pf + fs[:, 2]

    nrows = x.shape[0]
    fp = jnp.zeros((nrows,), x.dtype)
    fp = fp.at[:nlocal_pad].set(fp_local)
    if fp_exchange is None:
        gcap = border_map.shape[0]
        fp = fp.at[nlocal_pad : nlocal_pad + gcap].set(fp[border_map])
    else:
        fp = fp_exchange(fp)

    # pass 2: pair forces (force_eam.c:122-227), recip chain pre-folded
    fpj = fp[neighbors]
    fpair = jnp.where(
        mask,
        -((fp_local[:, None] + fpj) * _horner(poly.g1, t)
          + _horner(poly.g2, t)),
        0.0,
    )
    fx = jnp.sum(dx * fpair, axis=1)
    fy = jnp.sum(dy * fpair, axis=1)
    fz = jnp.sum(dz * fpair, axis=1)
    return jnp.stack([fx, fy, fz], axis=1), fp
