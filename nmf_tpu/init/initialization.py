"""Factor initializers: random and NNDSVD(+a, +ar).

Behavioral reference: /root/reference/src/initialization.jl — ``randinit``
(:4-17) and the Boutsidis-Gallopoulos NNDSVD family (:19-137).

Design notes: the reference's NNDSVD loops over components, splitting each
singular-vector pair into +/- parts with scalar kernels (:26-72,103-137).
All k components are independent, so here the entire construction is one
vectorized elementwise program over the (p x k) / (n x k) singular-vector
blocks — a handful of fused elementwise passes, no loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.rsvd import rsvd
from ..utils.numeric import normalize1_cols

__all__ = ["randinit", "nndsvd"]


def randinit(X_or_shape, k: int, *, normalize: bool = False, zeroh: bool = False, key=None, dtype=None):
    """Uniform random init (reference ``randinit``,
    src/initialization.jl:4-17): ``W ~ U[0,1)`` (optionally column-sum
    normalized), ``H ~ U[0,1)`` or zeros when ``zeroh``."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if hasattr(X_or_shape, "shape"):
        p, n = X_or_shape.shape
        dtype = dtype or X_or_shape.dtype
    else:
        p, n = X_or_shape
        dtype = dtype or jnp.float32
    kw, kh = jax.random.split(key)
    W = jax.random.uniform(kw, (p, k), dtype=dtype)
    if normalize:
        W = normalize1_cols(W)
    H = (
        jnp.zeros((k, n), dtype=dtype)
        if zeroh
        else jax.random.uniform(kh, (k, n), dtype=dtype)
    )
    return W, H


def _nndsvd_factors(U, s, V, meanX, variant: int, inith: bool, key, dtype):
    """Vectorized NNDSVD core (reference ``_nndsvd!``,
    src/initialization.jl:26-72).

    Per component j: split ``u_j, v_j`` into +/- parts, pick the side with
    larger mass ``m = ||x_side|| * ||y_side||``, scale by
    ``sqrt(s_j * m) / ||side||``; entries on the other side are filled with
    ``v0`` (0 for :std, mean(X) for :a, mean(X)*0.01*rand per component for
    :ar).
    """
    dt = dtype
    U = U.astype(dt)
    s = s.astype(dt)
    V = V.astype(dt)
    k = U.shape[1]
    zero = jnp.zeros((), dt)

    xp = jnp.where(U > 0, U, zero)
    xn = jnp.where(U > 0, zero, -U)  # includes zeros on the negative side
    yp = jnp.where(V > 0, V, zero)
    yn = jnp.where(V > 0, zero, -V)
    xpnrm = jnp.sqrt(jnp.sum(xp * xp, axis=0))  # (k,)
    xnnrm = jnp.sqrt(jnp.sum(xn * xn, axis=0))
    ypnrm = jnp.sqrt(jnp.sum(yp * yp, axis=0))
    ynnrm = jnp.sqrt(jnp.sum(yn * yn, axis=0))
    mp = xpnrm * ypnrm
    mn = xnnrm * ynnrm
    choose_p = mp >= mn  # (k,)

    if variant == 0:
        v0 = jnp.zeros((k,), dt)
    elif variant == 1:
        v0 = jnp.full((k,), meanX, dt)
    else:  # :ar — one fresh uniform scalar per component (src/initialization.jl:48-50)
        v0 = meanX * jnp.asarray(0.01, dt) * jax.random.uniform(key, (k,), dtype=dt)

    ss = jnp.sqrt(s * jnp.where(choose_p, mp, mn))  # (k,)

    def build(M, Mpos, Mneg, pnrm, nnrm):
        cpos = ss / jnp.where(pnrm > 0, pnrm, 1)
        cneg = ss / jnp.where(nnrm > 0, nnrm, 1)
        # scalepos!: y = x*c where x > 0 else v0 (src/initialization.jl:117-125)
        pos = jnp.where(M > 0, Mpos * cpos[None, :], v0[None, :])
        # scaleneg!: y = -x*c where x < 0 else v0 (src/initialization.jl:127-137)
        neg = jnp.where(M < 0, Mneg * cneg[None, :], v0[None, :])
        return jnp.where(choose_p[None, :], pos, neg)

    W = build(U, xp, xn, xpnrm, xnnrm)
    Ht = build(V, yp, yn, ypnrm, ynnrm) if inith else None
    return W, Ht


def nndsvd(X, k: int, *, zeroh: bool = False, variant: str = "std", initdata=None, key=None):
    """NNDSVD initialization (reference ``nndsvd``,
    src/initialization.jl:74-101).

    ``initdata`` may be a ``(U, s, V)`` tuple (V as n x r columns) or an
    object with ``U``/``S``/``V`` attributes (a Julia-style SVD
    factorization); otherwise a randomized SVD is computed on-device.
    ``variant`` is one of "std", "a", "ar".
    """
    if not matops.is_sparse(X):
        X = jnp.asarray(X)
    dt = X.dtype
    n = X.shape[1]
    ivar = {"std": 0, "a": 1, "ar": 2}.get(variant)
    if ivar is None:
        raise ValueError("Invalid value for variant")
    if key is None:
        key = jax.random.PRNGKey(0)
    ksvd, kar = jax.random.split(key)

    if initdata is None:
        U, s, V = rsvd(X, k, key=ksvd)
    else:
        if isinstance(initdata, tuple):
            U, s, V = initdata
        else:
            U, s, V = initdata.U, initdata.S, initdata.V
        U = jnp.asarray(U)[:, :k]
        s = jnp.asarray(s)[:k]
        V = jnp.asarray(V)[:, :k]

    meanX = matops.mean(X)
    if zeroh:
        W, _ = _nndsvd_factors(U, s, V, meanX, ivar, False, kar, dt)
        H = jnp.zeros((k, n), dt)
    else:
        W, Ht = _nndsvd_factors(U, s, V, meanX, ivar, True, kar, dt)
        H = Ht.T
    return W, H
