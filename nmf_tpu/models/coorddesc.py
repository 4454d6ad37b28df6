"""Coordinate descent / Fast-HALS (Cichocki & Phan), scikit-learn semantics.

Behavioral reference: /root/reference/src/coorddesc.jl (options :24-46,
regularization split :61-79, core sweep :109-159, transpose-trick H update
:162-175).

Design notes
------------
The reference's core loop is a strictly sequential scalar Newton sweep over
(component t, row i).  The data dependency is only across *components* — all
rows are independent — so the sweep becomes a ``lax.fori_loop`` over the k
components, each step updating one full column of W with a rank-1 matvec
``W @ HHt[:, t]``.  Exact HALS semantics (each
coordinate uses already-updated values of the other components) are
preserved; only the row dimension is vectorized.

The reference tracks a ``violation`` statistic that never feeds the stopping
rule (src/coorddesc.jl:147-149, :178-180 is dead code per SURVEY.md) — not
replicated.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.objectives import mse_objective
from .common import Result, data_field, nmf_skeleton, register_solver, static_field

__all__ = ["CoordinateDescent"]

_REGULARIZATION = ("both", "components", "transformation", "none")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Options for coordinate descent (reference ``CoordinateDescent{T}``,
    src/coorddesc.jl:24-46).

    ``alpha`` scales the regularization; ``l1ratio`` mixes L1 vs L2;
    ``regularization`` selects whether it hits H ("components"),
    W ("transformation"), "both" or "none" (src/coorddesc.jl:61-79).
    ``shuffle`` randomizes the component order each sweep; pass ``key`` for a
    deterministic stream (the reference uses the global RNG)."""

    maxiter: int = static_field(default=100)
    verbose: bool = static_field(default=False)
    tol: float | None = data_field(default=None)
    update_H: bool = static_field(default=True)
    alpha: float = data_field(default=0.0)
    l1ratio: float = data_field(default=0.0)
    regularization: str = static_field(default="both")
    shuffle: bool = static_field(default=False)
    key: jax.Array | None = data_field(default=None)

    def __post_init__(self):
        if self.regularization not in _REGULARIZATION:
            raise ValueError(
                f"regularization must be one of {_REGULARIZATION}."
            )

    def _resolved(self, dtype):
        from ..utils.dtypes import cbrt_eps

        tol = self.tol if self.tol is not None else cbrt_eps(dtype)
        upd = self
        if self.key is None:
            upd = dataclasses.replace(self, key=jax.random.PRNGKey(0))
        return upd, tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, self.maxiter, self.verbose, tol, trace)


def _regsplit(upd: CoordinateDescent, dtype):
    """(l1W, l2W, l1H, l2H) per src/coorddesc.jl:61-79."""
    alpha = jnp.asarray(upd.alpha, dtype)
    l1r = jnp.asarray(upd.l1ratio, dtype)
    zero = jnp.zeros((), dtype)
    aH = alpha if upd.regularization in ("both", "components") else zero
    aW = alpha if upd.regularization in ("both", "transformation") else zero
    return aW * l1r, aW * (1 - l1r), aH * l1r, aH * (1 - l1r)


def _halfstep(X, W, H, l1, l2, perm):
    """Update ``W`` (rows x k) holding ``H`` (k x cols) fixed — the
    reference's ``_update_coord_descent!`` (src/coorddesc.jl:109-159) with
    the row loop vectorized.  ``perm`` gives the component visit order."""
    dt = W.dtype
    k = H.shape[0]
    eye = jnp.eye(k, dtype=dt)
    HHt = H @ H.T + l2 * eye
    XHt = matops.mm(X, H.T) - l1
    Pdiag = jnp.diagonal(HHt)

    def body(t, W):
        c = perm[t]
        # grad[i] = sum_r HHt[c, r] * W[i, r] - XHt[i, c]
        grad = W @ jnp.take(HHt, c, axis=1) - jnp.take(XHt, c, axis=1)
        hess = Pdiag[c]
        safe = jnp.where(hess != 0, hess, jnp.ones((), dt))
        old = jnp.take(W, c, axis=1)
        new = jnp.where(
            hess != 0, jnp.maximum(old - grad / safe, jnp.zeros((), dt)), old
        )
        return jax.lax.dynamic_update_slice(W, new[:, None], (0, c))

    return jax.lax.fori_loop(0, k, body, W)


def _prepare(upd: CoordinateDescent, X, W, H):
    key = upd.key if upd.key is not None else jax.random.PRNGKey(0)
    return (key,)


def _update(upd: CoordinateDescent, state, X, W, H):
    """One sweep: W first, then H by the transpose trick
    (src/coorddesc.jl:162-175)."""
    (key,) = state
    dt = W.dtype
    k = W.shape[1]
    l1W, l2W, l1H, l2H = _regsplit(upd, dt)

    if upd.shuffle:
        key, k1, k2 = jax.random.split(key, 3)
        permW = jax.random.permutation(k1, k)
        permH = jax.random.permutation(k2, k)
    else:
        permW = permH = jnp.arange(k)

    W = _halfstep(X, W, H, l1W, l2W, permW)
    if upd.update_H:
        H = _halfstep(matops.transpose(X), H.T, W.T, l1H, l2H, permH).T
    return W, H, (key,)


def _objective(upd: CoordinateDescent, state, X, W, H):
    return mse_objective(X, W, H)


register_solver(CoordinateDescent, prepare=_prepare, update=_update,
                objective=_objective)
