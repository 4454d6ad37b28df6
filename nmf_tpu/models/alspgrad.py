"""Alternating least squares via projected gradient (Lin 2007).

Behavioral reference: /root/reference/src/alspgrad.jl — the largest solver in
the reference.  Each outer sweep runs two inner projected-gradient solves
(H then W), each with an adaptive backtracking line search (grow-or-shrink
alpha decided at the first trial, :138-178) and a projected-gradient-norm
stopping rule (:9-19).  The outer updater multiplies ``tolg`` by 0.1 whenever
an inner solve converges in a single iteration (:409-421).

Design notes
------------
Both inner solves reduce to the same canonical problem
``min_{Y >= 0} 0.5 || A Y - B ||^2`` given the Grams ``AtA = A'A`` (k x k)
and ``AtB = A'B`` (k x m):

* H-update: ``A = W``, ``B = X``, ``Y = H``.
* W-update: ``A = H'``, ``B = X'``, ``Y = W'`` (the gradient
  ``W HH' - XH'`` is the transpose of ``HH' W' - (XH')'``).

So one jitted subsolver serves both, and X is touched only once per sweep per
factor (to build ``W'X`` / ``XH'``); every line-search trial costs a
k x k @ k x m matmul plus two fused reductions — no p x n traffic.

The reference's nested control flow (inner PG loop -> <=traceiter
backtracking trials) is **flattened into ONE ``lax.while_loop``** whose body
performs either a gradient phase (fresh ``G = AtA Y - AtB`` + projected-norm
convergence test) or a single line-search trial, selected by the carried
``ls_it`` counter.  Both phases share the body's single k x k @ k x m matmul
by selecting its right operand (``Y`` vs the trial direction ``D``), so the
flattening costs no extra FLOPs and the numerics match the nested form
exactly in exact arithmetic (the gradient is always freshly computed, never
incrementally updated; in floats the two compiled programs differ only by
fusion/reduction-order rounding, ~1 ulp).  Motivation: XLA compile time for nested while_loops is
super-linear in nesting depth (the nested form compiled about 8x slower
than the flat one for the full outer solve), and per-iteration the single
loop avoids the loop-entry/exit synchronization of the inner loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.objectives import mse_objective
from ..utils.dtypes import cbrt_eps, eps as _eps, quartic_root_eps
from .common import Result, data_field, nmf_skeleton, register_solver, static_field

__all__ = ["ALSPGrad", "alspgrad_updateh", "alspgrad_updatew"]


# ---------------------------------------------------------------------------
# The canonical projected-gradient subsolver


class _LSCarry(NamedTuple):
    Y: jax.Array  # accepted iterate (unchanged until a branch accepts)
    Yp: jax.Array  # "previous candidate" buffer (reference Hp/Wp)
    alpha: jax.Array
    decr: jax.Array  # shrinking (True) vs growing (False) alpha
    it: jax.Array
    done: jax.Array


def _projgradnorm(G, Y):
    """sqrt(sum of g^2 over entries with g<0 or y>0)
    (reference ``projgradnorm``, src/alspgrad.jl:9-19)."""
    mask = (G < 0) | (Y > 0)
    g2 = jnp.where(mask, G * G, jnp.zeros((), G.dtype))
    return jnp.sqrt(jnp.sum(g2))


def _ls_trial(Y, Yp, G, alpha, decr, first, Yn, D, M, beta, sigma):
    """ONE backtracking trial of the adaptive line search
    (src/alspgrad.jl:138-178), shared by the nested ``_line_search`` (verbose
    host path) and the trial phase of ``_pg_subsolve``'s flat while_loop —
    the single copy of the accept/adapt math.

    ``Y`` is the base iterate the search started from, ``Yn = max(Y -
    alpha*G, 0)`` the candidate, ``D = Yn - Y`` and ``M = AtA @ D`` are
    computed by the caller (the flat body shares that matmul with its
    gradient phase).  Returns ``(Y_out, Yp_next, alpha_next, decr_out,
    done)``."""
    dt = Y.dtype
    epsT = jnp.asarray(_eps(dt), dt)
    # Growing alpha unchecked can overflow to inf (the reference errors via
    # isfinite(alpha), src/alspgrad.jl:143); clamp so max(Y - alpha*G, 0)
    # never produces NaN where G == 0.
    alpha_cap = jnp.asarray(jnp.finfo(dt).max / 2, dt)
    dv1 = jnp.vdot(G, D)
    dv2 = jnp.vdot(M, D)
    suff_decr = (1 - sigma) * dv1 + jnp.asarray(0.5, dt) * dv2 < 0
    # First trial decides the direction and snapshots Yp <- Y (:157-160).
    decr = jnp.where(first, ~suff_decr, decr)
    Yp_eff = jnp.where(first, Y, Yp)
    # Frobenius isapprox(Yp, Yn, atol=eps(T)) (src/alspgrad.jl:169).
    close = jnp.linalg.norm(Yp_eff - Yn) <= epsT
    take_n = decr & suff_decr  # shrink branch accepts Yn
    take_p = (~decr) & ((~suff_decr) | close)  # grow branch accepts Yp
    done = take_n | take_p
    Y_out = jnp.where(take_n, Yn, jnp.where(take_p, Yp_eff, Y))
    alpha_next = jnp.where(
        done,
        alpha,
        jnp.where(decr, alpha * beta, jnp.minimum(alpha / beta, alpha_cap)),
    )
    # Growing and not done: remember this candidate (Yp <- Yn).
    Yp_next = jnp.where(done | decr, Yp_eff, Yn)
    return Y_out, Yp_next, alpha_next, decr, done


def _line_search(AtA, Y, G, alpha, traceiter, beta, sigma):
    """The adaptive backtracking line search (src/alspgrad.jl:138-178) as a
    nested while_loop over :func:`_ls_trial`.  Returns (Y, alpha,
    backtracks).  Used by the host-driven verbose path; the jitted solve path
    runs the same trial math inside ``_pg_subsolve``'s flat loop."""
    dt = Y.dtype
    zero = jnp.zeros((), dt)

    def cond(s: _LSCarry):
        return jnp.logical_and(~s.done, s.it < traceiter)

    def body(s: _LSCarry):
        it = s.it + 1
        first = it == 1
        Yn = jnp.maximum(Y - s.alpha * G, zero)
        D = Yn - Y
        Y_out, Yp_next, alpha_next, decr, done = _ls_trial(
            Y, s.Yp, G, s.alpha, s.decr, first, Yn, D, AtA @ D, beta, sigma
        )
        return _LSCarry(Y_out, Yp_next, alpha_next, decr, it, done)

    init = _LSCarry(
        Y,
        jnp.zeros_like(Y),
        alpha,
        jnp.zeros((), bool),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), bool),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.Y, out.alpha, out.it


def _pg_step(AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma):
    """One outer PG iteration: gradient, projected-norm test, line search.
    Returns (Y, alpha, pgnrm, backtracks, converged)."""
    dt = Y.dtype
    G = AtA @ Y - AtB
    pgnrm = _projgradnorm(G, Y)
    converged = pgnrm < jnp.asarray(tolg, dt)
    Y, alpha, backtracks = jax.lax.cond(
        converged,
        lambda args: (args[0], args[2], jnp.zeros((), jnp.int32)),
        lambda args: _line_search(AtA, args[0], args[1], args[2], traceiter, beta, sigma),
        (Y, G, alpha),
    )
    return Y, alpha, pgnrm, backtracks, converged


class _FlatCarry(NamedTuple):
    Y: jax.Array  # accepted iterate
    Yp: jax.Array  # grow-branch candidate buffer (reference Hp/Wp)
    G: jax.Array  # gradient at Y, refreshed at each PG-iteration start
    alpha: jax.Array
    decr: jax.Array  # shrinking (True) vs growing (False) alpha
    ls_it: jax.Array  # 0 = next body is a gradient phase; >=1 = trial number
    t: jax.Array  # PG iterations started
    converged: jax.Array


def _pg_subsolve(AtA, AtB, Y0, maxiter, traceiter, tolg, beta, sigma):
    """Solve ``min_{Y>=0} 0.5||A Y - B||^2`` by Lin's projected gradient with
    adaptive backtracking (reference ``_alspgrad_updateh!``,
    src/alspgrad.jl:86-191; the W variant :242-347 is this on transposed
    data).  Returns ``(Y, t)`` with t the number of outer PG iterations.

    Alpha is initialized to 1 per subsolve call and persists across PG
    iterations (src/alspgrad.jl:120).  If a line search exhausts
    ``traceiter`` trials without accepting, Y is left unchanged for that
    iteration — exactly the reference's (non-)assignment behavior.

    Flattened single while_loop (see module docstring): each body iteration
    is either a gradient phase (``ls_it == 0``) or one backtracking trial
    (``ls_it >= 1``); the body's one matmul serves both phases by operand
    selection, so the math matches the nested form exactly.
    """
    dt = Y0.dtype
    zero = jnp.zeros((), dt)
    beta = jnp.asarray(beta, dt)
    sigma = jnp.asarray(sigma, dt)
    tolg = jnp.asarray(tolg, dt)

    def cond(c: _FlatCarry):
        return jnp.logical_and(~c.converged, (c.ls_it > 0) | (c.t < maxiter))

    def body(c: _FlatCarry):
        is_grad = c.ls_it == 0
        # Trial candidate from the carried gradient (stale & unused when
        # is_grad — the select below routes Y into the matmul instead).
        Yn = jnp.maximum(c.Y - c.alpha * c.G, zero)
        D = Yn - c.Y
        M = AtA @ jnp.where(is_grad, c.Y, D)  # the body's single matmul

        # --- gradient phase: fresh G, projected-norm convergence test
        # (src/alspgrad.jl:124-137) ---
        G_new = M - AtB
        pgnrm = _projgradnorm(G_new, c.Y)
        conv = pgnrm < tolg

        # --- trial phase: one backtracking step, the shared _ls_trial math
        # (M = AtA @ D in this phase) ---
        it = c.ls_it
        first = it == 1
        Y_trial, Yp_trial, alpha_trial, decr, done = _ls_trial(
            c.Y, c.Yp, c.G, c.alpha, c.decr, first, Yn, D, M, beta, sigma
        )
        # Alpha keeps its last adaptation even when trials run out
        # (src/alspgrad.jl:161-176).
        exhausted = (~done) & (it >= traceiter)

        return _FlatCarry(
            Y=jnp.where(is_grad, c.Y, Y_trial),
            Yp=jnp.where(is_grad, c.Yp, Yp_trial),
            G=jnp.where(is_grad, G_new, c.G),
            alpha=jnp.where(is_grad, c.alpha, alpha_trial),
            decr=jnp.where(is_grad, c.decr, decr),
            ls_it=jnp.where(
                is_grad,
                jnp.where(conv, 0, 1),
                jnp.where(done | exhausted, 0, it + 1),
            ).astype(jnp.int32),
            t=c.t + jnp.where(is_grad, 1, 0).astype(jnp.int32),
            converged=c.converged | (is_grad & conv),
        )

    init = _FlatCarry(
        Y0,
        jnp.zeros_like(Y0),
        jnp.zeros_like(Y0),
        jnp.ones((), dt),
        jnp.zeros((), bool),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), bool),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.Y, out.t


@jax.jit
def _pg_step_jit(AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma):
    return _pg_step(AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma)


def _pg_solve_verbose(AtA, AtB, normB2, Y, maxiter, traceiter, tolg, beta, sigma):
    """Host-driven PG solve printing the reference's per-iteration table
    (Iter / objv / objv.change / 1st-ord / alpha / back-tracks,
    src/alspgrad.jl:107-113,181-188)."""
    dt = Y.dtype

    def objective(Y):
        return float(
            0.5 * (jnp.vdot(Y, AtA @ Y) - 2 * jnp.vdot(AtB, Y) + normB2)
        )

    print(
        f"{'Iter':>5}    {'objv':>12}    {'objv.change':>12}    "
        f"{'1st-ord':>12}    {'alpha':>8}    {'back-tracks':>12}"
    )
    objv = objective(Y)
    print(f"{0:5d}    {objv:12.5e}")
    alpha = jnp.ones((), dt)
    t = 0
    converged = False
    while not converged and t < maxiter:
        t += 1
        Y, alpha, pgnrm, backtracks, conv_a = _pg_step_jit(
            AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma
        )
        converged = bool(conv_a)
        preobjv = objv
        objv = objective(Y)
        print(
            f"{t:5d}    {objv:12.5e}    {objv - preobjv:12.5e}    "
            f"{float(pgnrm):12.5e}    {float(alpha):8.4f}    {int(backtracks):12d}"
        )
    return Y, t


@jax.jit
def _pg_solve_h(X, W, H, maxiter, traceiter, tolg, beta, sigma):
    WtW = W.T @ W
    WtX = matops.mtm(W.T, X)
    return _pg_subsolve(WtW, WtX, H, maxiter, traceiter, tolg, beta, sigma)


@jax.jit
def _pg_solve_w(X, W, H, maxiter, traceiter, tolg, beta, sigma):
    HHt = H @ H.T
    XHt = matops.mm(X, H.T)
    Wt, t = _pg_subsolve(HHt, XHt.T, W.T, maxiter, traceiter, tolg, beta, sigma)
    return Wt.T, t


def alspgrad_updateh(
    X,
    W,
    H,
    *,
    maxiter: int = 1000,
    traceiter: int = 20,
    tolg: float | None = None,
    beta: float = 0.2,
    sigma: float = 0.01,
    verbose: bool = False,
):
    """Per-factor public solver (reference ``alspgrad_updateh!``,
    src/alspgrad.jl:69-84).  Returns ``(H, niters)``.  ``tolg`` defaults to
    ``cbrt(eps(T))``.

    ``verbose`` prints the reference's per-iteration table via a host-driven
    loop.  The verbose path runs a *different compiled program* (nested
    ``_pg_step``) than the non-verbose flat while_loop: the math is
    identical, but floating-point summation order may differ by ~1 ulp, so a
    verbose run can return bit-different factors and — in borderline cases —
    a different trial/iteration count than the same call without verbose
    (test_alspgrad.py pins the agreement bound)."""
    if tolg is None:
        tolg = cbrt_eps(H.dtype)
    if verbose:
        from ..ops import matops

        WtW = W.T @ W
        WtX = matops.mtm(W.T, X)
        normB2 = matops.sq_norm(X)
        return _pg_solve_verbose(
            WtW, WtX, normB2, H, maxiter, traceiter, tolg, beta, sigma
        )
    H, t = _pg_solve_h(X, W, H, maxiter, traceiter, tolg, beta, sigma)
    return H, int(t)


def alspgrad_updatew(
    X,
    W,
    H,
    *,
    maxiter: int = 1000,
    traceiter: int = 20,
    tolg: float | None = None,
    beta: float = 0.2,
    sigma: float = 0.01,
    verbose: bool = False,
):
    """Per-factor public solver (reference ``alspgrad_updatew!``,
    src/alspgrad.jl:225-240).  Returns ``(W, niters)``.  The same
    verbose/non-verbose ~1-ulp divergence note as ``alspgrad_updateh``
    applies."""
    if tolg is None:
        tolg = cbrt_eps(W.dtype)
    if verbose:
        from ..ops import matops

        HHt = H @ H.T
        XHt = matops.mm(X, H.T)
        normB2 = matops.sq_norm(X)
        Wt, t = _pg_solve_verbose(
            HHt, XHt.T, normB2, W.T, maxiter, traceiter, tolg, beta, sigma
        )
        return Wt.T, t
    W, t = _pg_solve_w(X, W, H, maxiter, traceiter, tolg, beta, sigma)
    return W, int(t)


# ---------------------------------------------------------------------------
# The outer alternating solver


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ALSPGrad:
    """Options for ALS projected gradient (reference ``ALSPGrad{T}``,
    src/alspgrad.jl:352-373).  ``tolg`` defaults to ``eps(T)^(1/4)`` and
    decays by 10x whenever an inner solve converges in one iteration."""

    maxiter: int = static_field(default=100)
    maxsubiter: int = static_field(default=200)
    verbose: bool = static_field(default=False)
    tol: float | None = data_field(default=None)
    tolg: float | None = data_field(default=None)
    update_H: bool = static_field(default=True)

    def _resolved(self, dtype):
        upd = dataclasses.replace(
            self,
            tol=self.tol if self.tol is not None else cbrt_eps(dtype),
            tolg=self.tolg if self.tolg is not None else quartic_root_eps(dtype),
        )
        return upd, upd.tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, upd.maxiter, upd.verbose, tol, trace)


def _prepare(upd: ALSPGrad, X, W, H):
    # tolg decays across outer iterations (src/alspgrad.jl:409-421) -> state.
    return (jnp.asarray(upd.tolg, W.dtype),)


def _update(upd: ALSPGrad, state, X, W, H):
    """One outer sweep (reference ``update_wh!``, src/alspgrad.jl:400-425):
    inner H solve, tolg decay, inner W solve, tolg decay."""
    (tolg,) = state
    dt = W.dtype
    beta = jnp.asarray(0.2, dt)
    sigma = jnp.asarray(0.01, dt)
    traceiter = 20

    if upd.update_H:
        WtW = W.T @ W
        WtX = matops.mtm(W.T, X)
        H, iterH = _pg_subsolve(
            WtW, WtX, H, upd.maxsubiter, traceiter, tolg, beta, sigma
        )
        tolg = jnp.where(iterH == 1, tolg * jnp.asarray(0.1, dt), tolg)

    HHt = H @ H.T
    XHt = matops.mm(X, H.T)
    Wt, iterW = _pg_subsolve(
        HHt, XHt.T, W.T, upd.maxsubiter, traceiter, tolg, beta, sigma
    )
    W = Wt.T
    tolg = jnp.where(iterW == 1, tolg * jnp.asarray(0.1, dt), tolg)
    return W, H, (tolg,)


def _objective(upd: ALSPGrad, state, X, W, H):
    return mse_objective(X, W, H)


register_solver(ALSPGrad, prepare=_prepare, update=_update,
                objective=_objective)
