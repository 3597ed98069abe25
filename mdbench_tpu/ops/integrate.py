"""Velocity-Verlet integration and PBC position wrap.

Reference: src/verletlist/integrate.c:21-40 (split Verlet) and
src/verletlist/pbc.c:59-84 (`updateAtomsPbc` box wrap). These are
trivially fused element-wise ops inside the jitted step scan.
"""

from __future__ import annotations

import jax.numpy as jnp


def initial_integrate(x, v, f, dt: float, dtforce: float, nlocal: int):
    """v += dtforce * f; x += dt * v — for local rows only
    (reference: integrate.c:21-31). Padded/ghost rows are untouched.
    """
    v = v.at[:nlocal].add(dtforce * f[:nlocal])
    x = x.at[:nlocal].add(dt * v[:nlocal])
    return x, v


def final_integrate(v, f, dtforce: float, nlocal: int):
    """v += dtforce * f (reference: integrate.c:33-40)."""
    return v.at[:nlocal].add(dtforce * f[:nlocal])


def wrap_into_box(x, prd, nlocal: int):
    """Relocate local atoms that left the box by one period
    (reference: pbc.c:59-84 — single add/subtract, not modulo, matching
    the reference exactly for atoms that moved < one box length).
    """
    xl = x[:nlocal]
    prd = jnp.asarray(prd, x.dtype)
    xl = jnp.where(xl < 0.0, xl + prd, xl)
    xl = jnp.where(xl >= prd, xl - prd, xl)
    return x.at[:nlocal].set(xl)
