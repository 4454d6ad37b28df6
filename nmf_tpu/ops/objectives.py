"""Objective functions.

The reference computes objectives through StatsBase: ``sqL2dist`` (sum of
squared differences) and ``gkldiv`` (generalized KL divergence), always on a
fully-materialized ``WH`` buffer (e.g. /root/reference/src/multupd.jl:81,148,
src/projals.jl:66, src/spa.jl:73-75).

Redesign: the p*n product never needs to live in device memory.  We evaluate
objectives *tile-wise* — a `lax.map` over column blocks of H, each block doing
one matmul (W @ H_block) and a fused reduction.  For small problems a single
fused expression is used (XLA fuses subtract/square/sum into the matmul
epilogue).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.dtypes import eps as _eps

__all__ = [
    "sqL2dist",
    "gkldiv",
    "mse_objective",
    "kl_objective",
]

# Column-block size used when evaluating objectives without materializing WH.
_BLOCK_N = 2048
# Matrices with fewer than this many entries just materialize WH.
_SMALL = 1 << 22  # 4M entries


def sqL2dist(a, b):
    """Sum of squared differences ``sum((a - b)^2)`` (StatsBase.sqL2dist)."""
    d = a - b
    return jnp.sum(d * d)


def gkldiv(a, b):
    """Generalized Kullback-Leibler divergence
    ``sum(a*log(a/b) - a + b)`` with the ``a == 0`` terms contributing ``b``
    (StatsBase.gkldiv semantics)."""
    a_pos = a > 0
    safe_a = jnp.where(a_pos, a, 1)
    safe_b = jnp.where(b > 0, b, 1)
    term = jnp.where(a_pos, safe_a * (jnp.log(safe_a) - jnp.log(safe_b)) - a + b, b)
    return jnp.sum(term)


def _blockwise_sum(X, W, H, tilefun):
    """``sum_j tilefun(X[:, j_block], (W @ H)[:, j_block])`` without ever
    materializing the full ``W @ H``.

    Pads n up to a multiple of the block size with zero columns of X and H —
    both objectives vanish on (x=0, wh=0) tiles, so padding adds exactly 0.
    """
    p, n = X.shape
    k = W.shape[1]
    bn = min(_BLOCK_N, n)
    nblocks = -(-n // bn)
    n_pad = nblocks * bn - n
    if n_pad:
        X = jnp.pad(X, ((0, 0), (0, n_pad)))
        H = jnp.pad(H, ((0, 0), (0, n_pad)))
    Xb = X.reshape(p, nblocks, bn).transpose(1, 0, 2)
    Hb = H.reshape(k, nblocks, bn).transpose(1, 0, 2)

    def body(carry, xh):
        xblk, hblk = xh
        whblk = W @ hblk
        return carry + tilefun(xblk, whblk), None

    total, _ = jax.lax.scan(body, jnp.zeros((), X.dtype), (Xb, Hb))
    return total


def mse_objective(X, W, H):
    """``0.5 * ||X - W@H||_F^2`` — the reference's MSE objective
    (0.5 * sqL2dist, src/multupd.jl:81).

    Sparse X: uses ``||X||^2 - 2<X, WH> + <W'W, HH'>`` with the inner
    product sampled at the nonzeros (SDDMM) — WH is never materialized.
    """
    from . import matops

    half = jnp.asarray(0.5, W.dtype)
    if matops.is_sparse(X) or matops.is_sharded_tiled(X):
        # Gram identity with only mm(): <X, WH> = <W, X @ H'>, one (p, k)
        # temporary and the product the solvers already run.
        cross = jnp.vdot(W, matops.mm(X, H.T))
        wh_sq = jnp.vdot(W.T @ W, H @ H.T)
        return half * (matops.sq_norm(X) - 2 * cross + wh_sq)
    if X.size <= _SMALL:
        return half * sqL2dist(X, W @ H)
    return half * _blockwise_sum(X, W, H, sqL2dist)


def kl_objective(X, W, H, delta=None):
    """``gkldiv(X, W@H)`` — the reference's divergence objective
    (src/multupd.jl:148).

    Sparse X: ``sum_{x>0}[x log(x/wh) - x] + sum_all(wh)`` with wh sampled
    at the nonzeros and ``sum_all(wh) = colsum(W) . rowsum(H)``.
    """
    from . import matops

    if matops.is_sparse(X):
        xv = matops.nnz_values(X)
        wh_at_nnz = matops.sddmm(W, H, X)
        pos = xv > 0
        safe_x = jnp.where(pos, xv, 1)
        safe_wh = jnp.where(wh_at_nnz > 0, wh_at_nnz, 1)
        nnz_term = jnp.sum(
            jnp.where(pos, safe_x * (jnp.log(safe_x) - jnp.log(safe_wh)) - xv, 0)
        )
        mass = jnp.vdot(jnp.sum(W, axis=0), jnp.sum(H, axis=1))
        return nnz_term + mass
    if X.size <= _SMALL:
        return gkldiv(X, W @ H)
    return _blockwise_sum(X, W, H, gkldiv)
