"""Naive projected alternating least squares (L2-regularized).

Behavioral reference: /root/reference/src/projals.jl — minimize
``0.5||X - WH||^2 + (lambda_w/2)||W||^2 + (lambda_h/2)||H||^2`` by alternating
unconstrained least squares (via Cholesky on the k x k Grams) followed by
projection onto the non-negative orthant (:89-106).

Design notes: both Grams are k x k and replicated; with X sharded over a
(rows, cols) mesh the only communication per sweep is a k x k all-reduce of
``W'W`` / ``H H'`` and the sharded matmuls ``W'X`` / ``X H'`` — XLA inserts
those from sharding annotations.  Cholesky runs replicated on every device
(cheaper than communicating), see ``nmf_tpu.ops.linalg``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.linalg import pdrsolve, pdsolve
from ..ops.objectives import mse_objective
from ..utils.numeric import projectnn
from .common import Result, data_field, nmf_skeleton, register_solver, static_field

__all__ = ["ProjectedALS"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ProjectedALS:
    """Options for projected ALS (reference ``ProjectedALS{T}``,
    src/projals.jl:18-34).  ``lambda_w``/``lambda_h`` are **L2** coefficients
    and default to ``cbrt(eps(T))`` (resolved at solve time)."""

    maxiter: int = static_field(default=100)
    verbose: bool = static_field(default=False)
    tol: float | None = data_field(default=None)
    update_H: bool = static_field(default=True)
    lambda_w: float | None = data_field(default=None)
    lambda_h: float | None = data_field(default=None)

    def _resolved(self, dtype):
        from ..utils.dtypes import cbrt_eps

        ce = cbrt_eps(dtype)
        upd = dataclasses.replace(
            self,
            tol=self.tol if self.tol is not None else ce,
            lambda_w=self.lambda_w if self.lambda_w is not None else ce,
            lambda_h=self.lambda_h if self.lambda_h is not None else ce,
        )
        return upd, upd.tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, upd.maxiter, upd.verbose, tol, trace)


def _prepare(upd: ProjectedALS, X, W, H):
    return ()


def _update(upd: ProjectedALS, state, X, W, H):
    """One sweep (src/projals.jl:80-106): H from a ridge-regularized normal
    equation + projection, then W from the mirrored right-solve + projection."""
    dt = W.dtype
    k = W.shape[1]
    lam_w = jnp.asarray(upd.lambda_w, dt)
    lam_h = jnp.asarray(upd.lambda_h, dt)
    eye = jnp.eye(k, dtype=dt)

    # The k x k Grams feed a Cholesky: computed at a reduced matmul
    # precision their rounding can exceed the lambda ridge and make them
    # *indefinite* -> NaN factors (at 100k x 10k k=64 the Gram scale is
    # ~1.6e5 against a lambda of 4.9e-3).  They are O(k/n) of the sweep's
    # flops, so exact f32 here is free, whatever precision the caller set.
    hi = jax.lax.Precision.HIGHEST
    if upd.update_H:
        WtW = jnp.matmul(W.T, W, precision=hi) + lam_h * eye
        H = projectnn(pdsolve(WtW, matops.mtm(W.T, X)))

    HHt = jnp.matmul(H, H.T, precision=hi) + lam_w * eye
    W = projectnn(pdrsolve(matops.mm(X, H.T), HHt))
    return W, H, state


def _objective(upd: ProjectedALS, state, X, W, H):
    """``0.5||X-WH||^2 (+ 0.5*lambda_w||W||^2 + 0.5*lambda_h||H||^2)``
    (src/projals.jl:63-74)."""
    dt = W.dtype
    half = jnp.asarray(0.5, dt)
    r = mse_objective(X, W, H)
    r = r + half * jnp.asarray(upd.lambda_w, dt) * jnp.sum(W * W)
    r = r + half * jnp.asarray(upd.lambda_h, dt) * jnp.sum(H * H)
    return r


register_solver(ProjectedALS, prepare=_prepare, update=_update,
                objective=_objective)
