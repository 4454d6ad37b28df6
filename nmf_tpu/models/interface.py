"""The ``nnmf`` front door.

Behavioral reference: /root/reference/src/interf.jl — validation rules
(:15-36), init dispatch (:42-56), algorithm dispatch (:61-80), and the
multi-start ``solve_replicates!`` (:85-101).

Defaults mirror the reference exactly: ``init="nndsvdar"``,
``alg="greedycd"``, ``maxiter=100``, ``tol=cbrt(eps(T)/100)``,
``replicates=1`` (src/interf.jl:4-9).

Extensions beyond the reference surface:
* ``key``/``seed`` — explicit PRNG threading (the reference uses Julia's
  global RNG); identical keys give identical runs across hosts.
* ``mesh`` — a ``jax.sharding.Mesh`` with ("rows", "cols") axes; X, W, H are
  placed with X: P(rows, cols), W: P(rows, None), H: P(None, cols) and every
  solver runs sharded (see ``nmf_tpu.parallel``).
* ``parallel_replicates`` — run the random restarts as a vmapped batch
  instead of a host loop (identical per-replicate semantics; JAX masks the
  while_loop per lane).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..init.initialization import nndsvd, randinit
from ..utils.dtypes import default_tol
from .alspgrad import ALSPGrad
from .common import Result, solve
from .coorddesc import CoordinateDescent
from .greedycd import GreedyCD
from .multupd import MultUpdate
from .projals import ProjectedALS
from .spa import SPA, spa

__all__ = ["nnmf", "solve_replicates"]

_ALGS = ("projals", "alspgrad", "multmse", "multdiv", "cd", "greedycd", "spa")
_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "spa", "custom")


def _check_nonneg(A, name):
    from ..ops import matops

    if matops.is_sparse(A):
        ok = bool(matops.all_nonneg(A))
    elif hasattr(A, "dtype"):
        ok = bool(jnp.all(A >= 0))
    else:
        ok = np.all(np.asarray(A) >= 0)
    if not ok:
        raise ValueError(f"The elements of {name} must be non-negative.")


def nnmf(
    X,
    k: int,
    *,
    init: str = "nndsvdar",
    initdata=None,
    alg: str = "greedycd",
    maxiter: int = 100,
    tol: float | None = None,
    replicates: int = 1,
    W0=None,
    H0=None,
    update_H: bool = True,
    verbose: bool = False,
    key=None,
    seed: int = 0,
    mesh=None,
    parallel_replicates: bool = False,
    trace: bool = False,
    dispatch_chunk: int | None = None,
) -> Result:
    """Non-negative matrix factorization: ``X (p x n) ~ W (p x k) @ H (k x n)``.

    Mirrors the reference ``nnmf`` (src/interf.jl:3-83) — same validation,
    same init/alg dispatch, same replicate policy, same ``Result`` contract.
    """
    from ..ops import matops

    if not (hasattr(X, "dtype") or matops.is_sparse(X)):
        X = jnp.asarray(X)
    T = X.dtype
    p, n = X.shape

    _check_nonneg(X, "X")
    if k > min(p, n):
        raise ValueError("The value of k should not exceed min(size(X)).")
    if replicates < 1:
        raise ValueError("The value of replicates must be positive.")
    if not update_H and init != "custom":
        warnings.warn("Only W will be updated.")

    if init == "custom":
        if W0 is None or H0 is None:
            raise ValueError("To use :custom initialization, set W0 and H0.")
        W0 = jnp.asarray(W0, T)
        H0 = jnp.asarray(H0, T)
        _check_nonneg(W0, "W0")
        if W0.shape != (p, k):
            raise ValueError("Invalid size for W0.")
        _check_nonneg(H0, "H0")
        if H0.shape != (k, n):
            raise ValueError("Invalid size for H0.")
    elif W0 is not None or H0 is not None:
        warnings.warn("Ignore W0 and H0 except for :custom initialization.")

    if tol is None:
        tol = default_tol(T)
    if key is None:
        key = jax.random.PRNGKey(seed)
    kinit, krep, kshuf = jax.random.split(key, 3)

    # ProjectedALS overwrites H before reading it, so H needn't be initialized
    # (src/interf.jl:38-39).
    initH = alg != "projals"

    if init == "random":
        W, H = randinit(X, k, zeroh=not initH, normalize=True, key=kinit)
    elif init == "nndsvd":
        W, H = nndsvd(X, k, zeroh=not initH, initdata=initdata, key=kinit)
    elif init == "nndsvda":
        W, H = nndsvd(X, k, variant="a", zeroh=not initH, initdata=initdata, key=kinit)
    elif init == "nndsvdar":
        W, H = nndsvd(X, k, variant="ar", zeroh=not initH, initdata=initdata, key=kinit)
    elif init == "spa":
        W, H = spa(X, k)
    elif init == "custom":
        W, H = W0, H0
    else:
        raise ValueError("Invalid value for init.")

    if mesh is not None:
        from ..parallel.sharding import shard_problem

        X, W, H = shard_problem(mesh, X, W, H)

    common = dict(maxiter=maxiter, tol=float(tol), verbose=verbose, update_H=update_H)
    if alg == "projals":
        alginst = ProjectedALS(**common)
    elif alg == "alspgrad":
        alginst = ALSPGrad(**common)
    elif alg == "multmse":
        alginst = MultUpdate(obj="mse", **common)
    elif alg == "multdiv":
        alginst = MultUpdate(obj="div", **common)
    elif alg == "cd":
        alginst = CoordinateDescent(key=kshuf, **common)
    elif alg == "greedycd":
        alginst = GreedyCD(**common)
    elif alg == "spa":
        if init != "spa":
            raise ValueError("Invalid value for init, use :spa instead.")
        alginst = SPA(obj="mse")
    else:
        raise ValueError("Invalid algorithm.")

    from .. import config

    with config.dispatch_chunk_scope(
        dispatch_chunk if dispatch_chunk is not None else config.dispatch_chunk
    ):
        return solve_replicates(
            alginst,
            X,
            W,
            H,
            replicates=replicates,
            initH=initH,
            key=krep,
            parallel=parallel_replicates,
            mesh=mesh,
            trace=trace,
        )


def solve_replicates(
    alginst, X, W, H, *, replicates: int, initH: bool, key=None,
    parallel: bool = False, mesh=None, trace: bool = False,
) -> Result:
    """Multi-start policy (reference ``solve_replicates!``,
    src/interf.jl:85-101): solve once from the requested init, then
    ``replicates - 1`` solves from fresh normalized random inits, keeping the
    minimum-objective Result."""
    if key is None:
        key = jax.random.PRNGKey(0)
    k = W.shape[1]

    ret = solve(alginst, X, W, H, trace)
    if replicates == 1:
        return ret

    # Both restart paths draw their init keys the same way
    # (``split(key, replicates - 1)``), so the vmapped batch solves exactly
    # the restarts the sequential loop would (tests pin the equivalence).
    if parallel and replicates > 1 and hasattr(alginst, "_solve"):
        from .replicates import solve_replicates_vmapped

        best = solve_replicates_vmapped(
            alginst, X, k, replicates - 1, initH=initH, key=key, mesh=mesh
        )
        if best is not None and best.objvalue < ret.objvalue:
            return best
        if best is not None:
            return ret

    minobjv = ret.objvalue
    for sub in jax.random.split(key, replicates - 1):
        Wr, Hr = randinit(X, k, zeroh=not initH, normalize=True, key=sub)
        if mesh is not None:
            from ..parallel.sharding import shard_problem

            _, Wr, Hr = shard_problem(mesh, X, Wr, Hr)
        tmp = solve(alginst, X, Wr, Hr)
        if minobjv > tmp.objvalue:
            ret = tmp
            minobjv = tmp.objvalue
    return ret
