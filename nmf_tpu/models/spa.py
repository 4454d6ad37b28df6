"""Successive Projection Algorithm (SPA) for separable NMF
(Gillis & Vavasis 2013).

Behavioral reference: /root/reference/src/spa.jl — the ``spa`` initialization
(:41-68) does all the actual work (anchor selection + batched NNLS for H);
the ``SPA`` "solver" (:71-80) is a statistics pass returning
``Result(W, H, 0, true, objv)``.

Design notes: the k anchor-selection rounds are a ``lax.fori_loop``; each
round is one fused column-norm reduction + argmax + a rank-1 deflation
(an outer-product update), all dense device work.  H comes from the batched FNNLS
component (``nmf_tpu.ops.fnnls``) instead of an external package.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops.fnnls import fnnls
from ..ops.objectives import kl_objective, mse_objective
from ..utils.numeric import projectnn
from .common import Result, static_field

__all__ = ["SPA", "spa", "separable_data"]


from functools import partial


@partial(jax.jit, static_argnums=1)
def _spa_anchors_k(X, k: int):
    """Column-sum-normalize then greedily pick k anchor columns by largest
    residual norm with rank-1 deflation (src/spa.jl:44-58)."""
    dt = X.dtype
    R0 = X / jnp.sum(X, axis=0, keepdims=True)

    def body(j, carry):
        R, ai = carry
        norms2 = jnp.sum(R * R, axis=0)
        a = jnp.argmax(norms2)
        p = jax.lax.dynamic_index_in_dim(R, a, axis=1, keepdims=False)
        ptR = p @ R
        R = R - jnp.outer(p, ptR) / jnp.vdot(p, p)
        return R, ai.at[j].set(a.astype(jnp.int32))

    _, ai = jax.lax.fori_loop(
        0, k, body, (R0, jnp.zeros((k,), jnp.int32))
    )
    return ai


@partial(jax.jit, static_argnums=1)
def _spa_anchors_sparse(X, k: int):
    """Anchor selection for sparse X without materializing the dense residual.

    Deflating ``R <- R - p(p'R)/(p'p)`` j times leaves
    ``R = (I - proj span{x_a1..x_aj}) Xn``, so instead of updating R we keep
    an orthonormal basis Q of the selected columns' span and track only the
    residual column norms: ``||r_c||^2 = ||x_c||^2 - sum_i (q_i' x_c)^2``.
    Each round costs one sparse column extract + one sparse matvec —
    O(k * nnz) total, no p x n dense traffic.
    """
    from ..ops import matops

    dt = X.dtype
    p, n = X.shape
    cs = matops.colsums(X)
    inv_cs = jnp.where(cs != 0, 1.0 / jnp.where(cs != 0, cs, 1), 0)
    # Xn = X with columns scaled to sum 1 (src/spa.jl:44)
    vals = matops.nnz_values(X)
    cols = matops.col_indices(X)
    Xn = matops.scale_values(X, vals * inv_cs[cols])

    # column squared norms of Xn
    norms2 = jnp.zeros((n,), dt).at[cols].add(matops.nnz_values(Xn) ** 2)

    def body(j, carry):
        norms2, Qb, ai = carry
        a = jnp.argmax(norms2)
        onehot = jnp.zeros((n,), dt).at[a].set(1)
        x_a = matops.mm(Xn, onehot[:, None])[:, 0]  # (p,) selected column
        r = x_a - Qb @ (Qb.T @ x_a)
        q = r / jnp.maximum(jnp.linalg.norm(r), jnp.finfo(dt).tiny)
        proj = matops.mtm(q[None, :], Xn)[0]  # (n,) q' Xn
        norms2 = jnp.maximum(norms2 - proj * proj, 0)
        Qb = Qb.at[:, j].set(q)
        return norms2, Qb, ai.at[j].set(a.astype(jnp.int32))

    _, _, ai = jax.lax.fori_loop(
        0, k, body, (norms2, jnp.zeros((p, k), dt), jnp.zeros((k,), jnp.int32))
    )
    return ai


def spa(X, k: int):
    """SPA initialization: returns ``(W, H)`` with ``W = X[:, anchors]`` and
    ``H = argmin_{H>=0} ||X - W H||`` via batched FNNLS (src/spa.jl:41-68).
    Sparse X uses the basis-tracking anchor selection (no dense residual)."""
    from ..ops import matops

    if matops.is_sparse(X):
        ai = _spa_anchors_sparse(X, int(k))
        onehots = jax.nn.one_hot(ai, X.shape[1], dtype=X.dtype).T  # (n, k)
        W = matops.mm(X, onehots)
    else:
        X = jnp.asarray(X)
        ai = _spa_anchors_k(X, int(k))
        W = jnp.take(X, ai, axis=1)
    H = projectnn(fnnls(W, X))
    return W, H


def separable_data(m: int, n: int, k: int, *, key=None):
    """Generate (W, H) for an exactly separable problem: ``H = [I V]`` with
    column-permuted columns and V's columns summing to <= 1
    (src/spa.jl:27-38)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    kw, kv, kp = jax.random.split(key, 3)
    W = jax.random.uniform(kw, (m, k))
    V = jax.random.uniform(kv, (k, n - k))
    V = V / jnp.sum(V, axis=0, keepdims=True)
    H = jnp.concatenate([jnp.eye(k, dtype=W.dtype), V], axis=1)
    perm = jax.random.permutation(kp, n)
    H = H[:, perm]
    return W, H


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SPA:
    """The SPA "solver": a no-op statistics pass over factors produced by the
    ``spa`` initialization (src/spa.jl:8-15,71-80)."""

    obj: str = static_field(default="mse")

    def __post_init__(self):
        if self.obj not in ("mse", "div"):
            raise ValueError("Invalid value for obj.")

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        if self.obj == "mse":
            objv = mse_objective(X, W, H)
        else:
            objv = kl_objective(X, W, H)
        return Result(W, H, 0, True, objv)
