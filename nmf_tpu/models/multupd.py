"""Lee-Seung multiplicative updates (MSE and KL-divergence objectives).

Behavioral reference: /root/reference/src/multupd.jl (options & validation
:18-43, MSE updater :56-116, divergence updater :121-193).

Design notes
------------
* The MSE H-step needs ``W'X`` and ``W'W H``.  The reference computes the
  latter as ``W' (W H)`` (O(p k n) flops); we use the Gram form
  ``(W'W) H`` (O(p k^2 + k^2 n)) — mathematically identical, far cheaper for
  p, n >> k, and it never touches X or a p x n buffer, so with X row/col
  sharded the H-step needs only a k x k all-reduce of ``W'W``.
* All elementwise update bodies fuse into the matmul epilogues under XLA.
* The divergence updater's p x n quotient ``Q = X ./ (W H + delta)`` is the
  memory hot spot (reference holds it in a full buffer,
  src/multupd.jl:128-145); XLA fuses it with the following matmul so it is
  never round-tripped to device memory more than once.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.objectives import kl_objective, mse_objective
from ..utils.dtypes import sqrt_eps
from .common import Result, data_field, nmf_skeleton, register_solver, static_field

__all__ = ["MultUpdate"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultUpdate:
    """Options for multiplicative updates (reference ``MultUpdate{T}``,
    src/multupd.jl:18-43).

    ``lambda_w``/``lambda_h`` are L1 regularization coefficients.  For the
    divergence objective they are floored at ``sqrt(eps(T))``
    (src/multupd.jl:38-39) — applied at solve time since the floor depends on
    the working dtype.
    """

    obj: str = static_field(default="mse")
    maxiter: int = static_field(default=100)
    verbose: bool = static_field(default=False)
    tol: float | None = data_field(default=None)
    update_H: bool = static_field(default=True)
    lambda_w: float = data_field(default=0.0)
    lambda_h: float = data_field(default=0.0)

    # Deprecated ``lambda`` kwarg (reference src/multupd.jl:32-36): maps onto
    # lambda_w/lambda_h where those are zero.  Python reserves ``lambda``, so
    # the keyword is ``lam``.
    lam: dataclasses.InitVar = None

    def __post_init__(self, lam=None):
        if lam is not None and isinstance(lam, (int, float)) and lam >= 0:
            import warnings

            warnings.warn(
                "lam is deprecated, use lambda_w and lambda_h instead.",
                DeprecationWarning,
            )
            if isinstance(self.lambda_w, (int, float)) and self.lambda_w == 0:
                object.__setattr__(self, "lambda_w", lam)
            if isinstance(self.lambda_h, (int, float)) and self.lambda_h == 0:
                object.__setattr__(self, "lambda_h", lam)
        if self.obj not in ("mse", "div"):
            raise ValueError("Invalid value for obj.")
        if isinstance(self.maxiter, int) and self.maxiter <= 1:
            raise ValueError("maxiter must be greater than 1.")
        if isinstance(self.tol, (int, float)) and not (self.tol > 0):
            raise ValueError("tol must be positive.")
        if isinstance(self.lambda_w, (int, float)) and self.lambda_w < 0:
            raise ValueError("lambda_w must be non-negative.")
        if isinstance(self.lambda_h, (int, float)) and self.lambda_h < 0:
            raise ValueError("lambda_h must be non-negative.")

    def _resolved(self, dtype):
        from ..utils.dtypes import cbrt_eps

        tol = self.tol if self.tol is not None else cbrt_eps(dtype)
        return self, tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, self.maxiter, self.verbose, tol, trace)


def _prepare(upd: MultUpdate, X, W, H):
    return ()


def _update(upd: MultUpdate, state, X, W, H):
    if upd.obj == "mse":
        return _update_mse(upd, state, X, W, H)
    return _update_div(upd, state, X, W, H)


def _update_mse(upd: MultUpdate, state, X, W, H):
    """One MU sweep for MSE: ``H .*= max(0, W'X - l_h) ./ (W'W H + delta)``
    then ``W .*= max(0, X H' - l_w) ./ (W H H' + delta)``
    (src/multupd.jl:96-115)."""
    dt = W.dtype
    delta = jnp.asarray(sqrt_eps(dt), dt)
    zero = jnp.zeros((), dt)
    lam_w = jnp.asarray(upd.lambda_w, dt)
    lam_h = jnp.asarray(upd.lambda_h, dt)

    if upd.update_H:
        WtX = matops.mtm(W.T, X)
        WtWH = (W.T @ W) @ H
        H = H * (jnp.maximum(zero, WtX - lam_h) / (WtWH + delta))

    XHt = matops.mm(X, H.T)
    WHHt = W @ (H @ H.T)
    W = W * (jnp.maximum(zero, XHt - lam_w) / (WHHt + delta))
    return W, H, state


def _update_div(upd: MultUpdate, state, X, W, H):
    """One MU sweep for generalized KL:
    ``H[i,j] *= (W'Q)[i,j] / (colsum(W)[i] + l_h)`` with
    ``Q = X ./ (W H + delta)``, then the mirrored W step with fresh Q
    (src/multupd.jl:170-192)."""
    dt = W.dtype
    delta = jnp.asarray(sqrt_eps(dt), dt)
    # :div floors the regularizers at sqrt(eps(T)) (src/multupd.jl:38-39).
    lam_w = jnp.maximum(jnp.asarray(upd.lambda_w, dt), delta)
    lam_h = jnp.maximum(jnp.asarray(upd.lambda_h, dt), delta)

    def quotient(W, H):
        # Q = X ./ (WH + delta); for sparse X this is an SDDMM at X's
        # pattern (0/y = 0) and the dense p x n WH is never formed.
        if matops.is_sparse(X):
            wh_at_nnz = matops.sddmm(W, H, X)
            return matops.scale_values(X, matops.nnz_values(X) / (wh_at_nnz + delta))
        return X / (W @ H + delta)

    if upd.update_H:
        WtQ = matops.mtm(W.T, quotient(W, H))
        sW = jnp.sum(W, axis=0)  # (k,)
        H = H * (WtQ / (sW[:, None] + lam_h))

    QHt = matops.mm(quotient(W, H), H.T)
    sH = jnp.sum(H, axis=1)  # (k,)
    W = W * (QHt / (sH[None, :] + lam_w))
    return W, H, state


def _objective(upd: MultUpdate, state, X, W, H):
    if upd.obj == "mse":
        return mse_objective(X, W, H)
    return kl_objective(X, W, H)


register_solver(MultUpdate, prepare=_prepare, update=_update,
                objective=_objective)
