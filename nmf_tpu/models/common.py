"""Shared iteration skeleton for all iterative NMF solvers.

The reference's key architectural idea (/root/reference/src/common.jl:41-89) is
one generic loop ``nmf_skeleton!`` parameterized by an updater implementing
``prepare_state`` / ``update_wh!`` / ``evaluate_objv``.  We keep the idea but
make it compile to one device program:

* updaters are **pure functions over pytrees** — each solver registers
  ``prepare(upd, X, W, H) -> state``, ``update(upd, state, X, W, H) ->
  (W, H, state)`` and ``objective(upd, state, X, W, H) -> scalar``;
* the main loop is a single jitted ``lax.while_loop`` — the whole solve
  (all iterations, the convergence test, the final objective) is one XLA
  program; no host round-trips per iteration;
* the convergence test (reference ``stop_condition``,
  src/common.jl:92-111) becomes a masked full reduction instead of an
  early-exit scalar scan — O((p+n)k) fused VPU work;
* option objects are dataclasses registered as jax pytrees: numeric
  hyperparameters (lambdas, tolerances) are *traced* leaves so changing them
  never recompiles; boolean/structure switches are static metadata.

``verbose=True`` switches to a host-driven loop of jitted single steps so the
per-iteration trace table (src/common.jl:57-58,76-82) can include real wall
time; results are identical.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.numeric import safe_div

__all__ = [
    "Result",
    "Trace",
    "nmf_checksize",
    "stop_condition",
    "nmf_skeleton",
    "register_solver",
    "solve",
    "static_field",
    "data_field",
]


# ---------------------------------------------------------------------------
# Option-dataclass helpers


def static_field(**kw):
    """Dataclass field treated as static pytree metadata (recompiles on change)."""
    kw.setdefault("metadata", {})
    kw["metadata"] = dict(kw["metadata"], static=True)
    return dataclasses.field(**kw)


def data_field(**kw):
    """Dataclass field treated as a traced pytree leaf (no recompiles)."""
    return dataclasses.field(**kw)


def nmf_checksize(X, W, H):
    """Validate that X (p x n), W (p x k), H (k x n) are consistent and
    return (p, n, k) (reference ``nmf_checksize``, src/common.jl:5-16)."""
    p, n = X.shape
    k = W.shape[1]
    if not (W.shape[0] == p and H.shape == (k, n)):
        raise ValueError("Dimensions of X, W, and H are inconsistent.")
    return p, n, k


# ---------------------------------------------------------------------------
# Result


class Trace(NamedTuple):
    """Per-iteration history (an extension of the reference's verbose
    table, src/common.jl:76-82): entry t holds the objective and the W&H
    relative change after iteration t+1; NaN beyond ``niters``."""

    objvalue: Any
    relchange: Any


class Result:
    """Outcome of an NMF solve — mirrors the reference ``Result{T}``
    (src/common.jl:21-38): factors, iteration count, convergence flag and the
    final objective value, with value-semantic ``==`` and ``hash``
    (src/common.jl:37-38).  ``trace`` (extension) optionally carries the
    per-iteration history and is excluded from equality/hashing."""

    __slots__ = ("W", "H", "niters", "converged", "objvalue", "trace")

    def __init__(self, W, H, niters, converged, objvalue, trace=None):
        if W.shape[1] != H.shape[0]:
            raise ValueError("Inner dimensions of W and H mismatch.")
        self.W = W
        self.H = H
        self.niters = int(niters)
        self.converged = bool(converged)
        self.objvalue = float(objvalue)
        self.trace = trace

    def __eq__(self, other):
        if not isinstance(other, Result):
            return NotImplemented
        return (
            np.array_equal(np.asarray(self.W), np.asarray(other.W))
            and np.array_equal(np.asarray(self.H), np.asarray(other.H))
            and self.niters == other.niters
            and self.converged == other.converged
            and self.objvalue == other.objvalue
        )

    def __hash__(self):
        return hash(
            (
                np.asarray(self.W).tobytes(),
                np.asarray(self.H).tobytes(),
                self.niters,
                self.converged,
                self.objvalue,
            )
        )

    def __repr__(self):
        return (
            f"Result(W={self.W.shape}, H={self.H.shape}, niters={self.niters}, "
            f"converged={self.converged}, objvalue={self.objvalue})"
        )


# ---------------------------------------------------------------------------
# Convergence test


def stop_condition(W, preW, H, preH, tol):
    """Relative per-component change test (reference ``stop_condition``,
    src/common.jl:92-111).

    For each component j: ``dev_w = sum_i (W[i,j]-preW[i,j])^2`` and
    ``sum_w = sum_i (W[i,j]+preW[i,j])^2`` (and the same over row j of H);
    converged iff ``sqrt(dev) <= tol*sqrt(sum)`` for both factors of every
    component.  Returns ``(converged, devmax)`` with
    ``devmax = max_j sqrt(max(dev_w/sum_w, dev_h/sum_h))`` (0/0 guarded to 0;
    the reference only ever prints this value).

    The reference early-exits the scalar loop; here the masked full
    reduction is a single fused pass and, when sharded, one scalar
    all-reduce.
    """
    dW = W - preW
    sW = W + preW
    dev_w = jnp.sum(dW * dW, axis=0)
    sum_w = jnp.sum(sW * sW, axis=0)
    dH = H - preH
    sH = H + preH
    dev_h = jnp.sum(dH * dH, axis=1)
    sum_h = jnp.sum(sH * sH, axis=1)
    tol = jnp.asarray(tol, dev_w.dtype)
    tol2 = tol * tol
    not_conv = (dev_w > tol2 * sum_w) | (dev_h > tol2 * sum_h)
    converged = ~jnp.any(not_conv)
    ratio = jnp.maximum(safe_div(dev_w, sum_w), safe_div(dev_h, sum_h))
    dev = jnp.sqrt(jnp.max(ratio))
    return converged, dev


# ---------------------------------------------------------------------------
# Solver registry: maps option-dataclass type -> implementation triple


class SolverImpl(NamedTuple):
    prepare: Callable[..., Any]
    update: Callable[..., Any]
    objective: Callable[..., Any]


_IMPLS: dict[type, SolverImpl] = {}


def register_solver(options_cls, *, prepare, update, objective):
    """Register the (prepare, update, objective) implementation for an
    options dataclass.  The dataclass must already be a jax pytree."""
    _IMPLS[options_cls] = SolverImpl(prepare, update, objective)
    return options_cls


def _impl_for(upd) -> SolverImpl:
    try:
        return _IMPLS[type(upd)]
    except KeyError:
        raise TypeError(f"No solver registered for {type(upd).__name__}") from None


# ---------------------------------------------------------------------------
# The skeleton


class _Carry(NamedTuple):
    W: jax.Array
    H: jax.Array
    state: Any
    t: jax.Array
    converged: jax.Array
    dev: jax.Array


@partial(jax.jit, static_argnames=("with_objective",))
def _solve_while_from(upd, state, X, W, H, t0, maxiter, tol, with_objective=True):
    """Resumable core: run the while_loop from iteration ``t0`` with an
    existing solver state.  Returns the final carry pieces including the
    solver state, so a host driver can checkpoint and continue with identical
    semantics (ALSPGrad's decaying tolg, CD's shuffle key, ... live in
    ``state``).  ``with_objective=False`` skips the final O(pn) objective
    pass (chunked drivers that only need it on the last chunk — checkpointing,
    time-to-tol — return NaN in its slot)."""
    impl = _impl_for(upd)
    dt = W.dtype

    def cond(c: _Carry):
        return jnp.logical_and(~c.converged, c.t < maxiter)

    def body(c: _Carry):
        with jax.named_scope("nmf_update"):
            Wn, Hn, sn = impl.update(upd, c.state, X, c.W, c.H)
        with jax.named_scope("nmf_stop_condition"):
            converged, dev = stop_condition(Wn, c.W, Hn, c.H, tol)
        return _Carry(Wn, Hn, sn, c.t + 1, converged, dev)

    init = _Carry(
        W,
        H,
        state,
        jnp.asarray(t0, jnp.int32),
        jnp.zeros((), bool),
        jnp.zeros((), dt),
    )
    final = jax.lax.while_loop(cond, body, init)
    if with_objective:
        with jax.named_scope("nmf_objective"):
            objv = impl.objective(upd, final.state, X, final.W, final.H)
    else:
        objv = jnp.full((), jnp.nan, dt)
    return final.W, final.H, final.state, final.t, final.converged, objv


#: donating twin of ``_solve_while_from`` for host-driven chunked loops
#: whose carried buffers are loop-owned (never the caller's arrays)
_solve_while_from_donating = partial(
    jax.jit,
    static_argnames=("with_objective",),
    donate_argnames=("state", "W", "H"),
)(_solve_while_from.__wrapped__)


@jax.jit
def _solve_while(upd, X, W, H, maxiter, tol):
    """Whole solve as one on-device while_loop.  Matches the reference loop
    (src/common.jl:64-83): t increments, update, convergence test; the
    objective is evaluated once on the final factors (src/common.jl:85-87)."""
    impl = _impl_for(upd)
    state = impl.prepare(upd, X, W, H)
    W, H, state, t, converged, objv = _solve_while_from(
        upd, state, X, W, H, 0, maxiter, tol
    )
    return W, H, t, converged, objv


@partial(jax.jit, static_argnames=("maxiter",))
def _solve_while_traced(upd, X, W, H, maxiter: int, tol):
    """Like _solve_while but records per-iteration (objective, relchange)
    history — the returned-history analogue of the reference's verbose trace
    table (src/common.jl:76-82).  maxiter is static (it sizes the history)."""
    impl = _impl_for(upd)
    state = impl.prepare(upd, X, W, H)
    dt = W.dtype

    class _TCarry(NamedTuple):
        c: _Carry
        objv_hist: jax.Array
        dev_hist: jax.Array

    def cond(tc: _TCarry):
        return jnp.logical_and(~tc.c.converged, tc.c.t < maxiter)

    def body(tc: _TCarry):
        c = tc.c
        Wn, Hn, sn = impl.update(upd, c.state, X, c.W, c.H)
        converged, dev = stop_condition(Wn, c.W, Hn, c.H, tol)
        objv = impl.objective(upd, sn, X, Wn, Hn)
        return _TCarry(
            _Carry(Wn, Hn, sn, c.t + 1, converged, dev),
            tc.objv_hist.at[c.t].set(objv),
            tc.dev_hist.at[c.t].set(dev),
        )

    init = _TCarry(
        _Carry(W, H, state, jnp.zeros((), jnp.int32), jnp.zeros((), bool), jnp.zeros((), dt)),
        jnp.full((maxiter,), jnp.nan, dt),
        jnp.full((maxiter,), jnp.nan, dt),
    )
    out = jax.lax.while_loop(cond, body, init)
    final = out.c
    objv = impl.objective(upd, final.state, X, final.W, final.H)
    return final.W, final.H, final.t, final.converged, objv, out.objv_hist, out.dev_hist


@jax.jit
def _solve_step(upd, state, X, W, H, tol):
    impl = _impl_for(upd)
    Wn, Hn, sn = impl.update(upd, state, X, W, H)
    converged, dev = stop_condition(Wn, W, Hn, H, tol)
    return Wn, Hn, sn, converged, dev


@partial(jax.jit, static_argnames=("chunk",))
def _solve_chunk(upd, state, X, W, H, remaining, tol, chunk: int):
    """Run up to ``chunk`` iterations on device, recording per-iteration
    (objective, relchange) history — one dispatch + one readback per chunk
    instead of per iteration.  Results are identical to single-stepping;
    only the wall-clock column granularity changes."""
    impl = _impl_for(upd)
    dt = W.dtype

    class _CCarry(NamedTuple):
        c: _Carry
        objv_hist: jax.Array
        dev_hist: jax.Array

    steps = jnp.minimum(jnp.asarray(chunk, jnp.int32), remaining)

    def cond(cc: _CCarry):
        return jnp.logical_and(~cc.c.converged, cc.c.t < steps)

    def body(cc: _CCarry):
        c = cc.c
        Wn, Hn, sn = impl.update(upd, c.state, X, c.W, c.H)
        converged, dev = stop_condition(Wn, c.W, Hn, c.H, tol)
        objv = impl.objective(upd, sn, X, Wn, Hn)
        return _CCarry(
            _Carry(Wn, Hn, sn, c.t + 1, converged, dev),
            cc.objv_hist.at[c.t].set(objv),
            cc.dev_hist.at[c.t].set(dev),
        )

    init = _CCarry(
        _Carry(W, H, state, jnp.zeros((), jnp.int32), jnp.zeros((), bool), jnp.zeros((), dt)),
        jnp.full((chunk,), jnp.nan, dt),
        jnp.full((chunk,), jnp.nan, dt),
    )
    out = jax.lax.while_loop(cond, body, init)
    c = out.c
    return c.W, c.H, c.state, c.t, c.converged, out.objv_hist, out.dev_hist


@jax.jit
def _prepare(upd, X, W, H):
    return _impl_for(upd).prepare(upd, X, W, H)


@jax.jit
def _objective(upd, state, X, W, H):
    return _impl_for(upd).objective(upd, state, X, W, H)


def nmf_skeleton(upd, X, W, H, maxiter, verbose, tol, trace: bool = False) -> Result:
    """Run the shared iteration skeleton and wrap the outcome in a Result.

    ``upd`` is an options pytree previously hooked up via
    :func:`register_solver`.  ``maxiter`` and ``tol`` are traced, so sweeping
    them does not recompile (except with ``trace=True``, where maxiter sizes
    the history buffers).
    """
    nmf_checksize(X, W, H)
    tol = jnp.asarray(tol, W.dtype)
    from .. import config

    with config.precision_scope(config.solver_precision(upd)):
        return _nmf_skeleton_inner(upd, X, W, H, maxiter, verbose, tol, trace)


def _solve_chunked_dispatch(upd, X, W, H, maxiter, tol, chunk: int) -> Result:
    """Host-driven solve dispatching at most ``chunk`` iterations per device
    call — the one-call contract (src/interf.jl:3-13) with a host re-entry
    (for checkpoints or progress) every ``chunk`` iterations.
    Bit-identical to :func:`_solve_while`: each chunk
    resumes the SAME jitted loop body from the carried solver state via
    ``_solve_while_from`` (clamping the iteration bound, not changing the
    body), and the objective runs once on the final factors."""
    state = _prepare(upd, X, W, H)
    maxiter_i = int(maxiter)
    t = 0
    converged = False
    step = _solve_while_from
    while not converged and t < maxiter_i:
        upto = min(t + chunk, maxiter_i)
        W, H, state, t_a, conv_a, _ = step(
            upd, state, X, W, H, t, upto, tol, with_objective=False
        )
        # donate the carried buffers from the second dispatch on: at
        # capacity scale (config7: W = 2.56 GB) input and output copies of
        # W/H/state per dispatch would double their device memory.
        # The FIRST dispatch must not donate — it consumes the caller's
        # factors, which stay valid user-visible arrays.
        step = _solve_while_from_donating
        t = int(t_a)
        converged = bool(conv_a)
    objv = _objective(upd, state, X, W, H)
    return Result(W, H, t, converged, objv)


def _nmf_skeleton_inner(upd, X, W, H, maxiter, verbose, tol, trace) -> Result:
    if trace:
        W, H, t, converged, objv, objv_hist, dev_hist = _solve_while_traced(
            upd, X, W, H, int(maxiter), tol
        )
        return Result(W, H, t, converged, objv, trace=Trace(objv_hist, dev_hist))
    if not verbose:
        from .. import config

        if config.dispatch_chunk:
            return _solve_chunked_dispatch(
                upd, X, W, H, maxiter, tol, config.dispatch_chunk
            )
        W, H, t, converged, objv = _solve_while(upd, X, W, H, maxiter, tol)
        return Result(W, H, t, converged, objv)

    # Host-driven loop with the reference's trace table (src/common.jl:54-82),
    # batched ``verbose_chunk`` iterations per device round-trip (the elapsed
    # column advances at chunk granularity; all printed values are exact).
    from .. import config

    chunk = config.effective_verbose_chunk()
    state = _prepare(upd, X, W, H)
    objv = float(_objective(upd, state, X, W, H))
    start = time.time()
    print(
        f"{'Iter':<5}    {'Elapsed time':<13}    {'objv':<13}    "
        f"{'objv.change':<13}    {'(W & H).relchange':<13}"
    )
    print(f"{0:5d}    {0.0:13.6e}    {objv:13.6e}")
    t = 0
    converged = False
    while not converged and t < maxiter:
        W, H, state, done, converged_a, objv_hist, dev_hist = _solve_chunk(
            upd, state, X, W, H, jnp.asarray(int(maxiter) - t, jnp.int32), tol, chunk
        )
        done = int(done)
        converged = bool(converged_a)
        elapsed = time.time() - start
        objv_hist = np.asarray(objv_hist)
        dev_hist = np.asarray(dev_hist)
        for i in range(done):
            t += 1
            preobjv = objv
            objv = float(objv_hist[i])
            print(
                f"{t:5d}    {elapsed:13.6e}    {objv:13.6e}    "
                f"{objv - preobjv:13.6e}    {float(dev_hist[i]):13.6e}"
            )
    return Result(W, H, t, converged, objv)


def solve(alg, X, W, H, trace: bool = False) -> Result:
    """Solve NMF with a configured algorithm object (the reference's
    ``NMF.solve!(alg, X, W, H)``, e.g. src/multupd.jl:45-52).  Returns a new
    Result; unlike the reference nothing is mutated in place.  ``trace=True``
    attaches per-iteration history (Result.trace)."""
    return alg._solve(X, W, H, trace)
