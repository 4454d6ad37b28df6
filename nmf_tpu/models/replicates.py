"""Vmapped multi-start replicates — an extension of the reference.

The reference runs its random restarts sequentially on the host
(/root/reference/src/interf.jl:85-101).  Here the restarts are an
embarrassingly parallel axis: we ``vmap`` the whole jitted solve over a batch
of random initializations.  JAX's while_loop batching masks each lane after
it converges, so every replicate reports exactly the ``niters`` / ``converged``
/ ``objvalue`` it would have reported sequentially; the device simply runs
all restarts in lockstep (cost = the slowest lane).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..init.initialization import randinit
from .common import Result, _solve_while

__all__ = ["solve_replicates_vmapped"]


def solve_replicates_vmapped(alginst, X, k, nrep, *, initH, key, mesh=None):
    """Run ``nrep`` random restarts in one vmapped solve and return the best
    Result (or None if the solver has no registered jitted path)."""
    if nrep < 1:
        return None
    try:
        upd, tol = alginst._resolved(X.dtype)
    except AttributeError:
        return None

    keys = jax.random.split(key, nrep)

    def make_init(kk):
        return randinit(X, k, zeroh=not initH, normalize=True, key=kk)

    Ws, Hs = jax.vmap(make_init)(keys)
    maxiter = alginst.maxiter
    tol = jnp.asarray(tol, X.dtype)

    batched = jax.vmap(
        _solve_while, in_axes=(None, None, 0, 0, None, None)
    )
    W, H, t, converged, objv = batched(upd, X, Ws, Hs, maxiter, tol)
    best = int(jnp.argmin(objv))
    return Result(W[best], H[best], t[best], converged[best], objv[best])
