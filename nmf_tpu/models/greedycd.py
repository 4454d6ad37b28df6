"""Greedy coordinate descent (Hsieh & Dhillon 2011) — the default ``nnmf``
algorithm.

Behavioral reference: /root/reference/src/greedycd.jl (options :10-31, core
``_update_GreedyCD!`` :94-166, transpose-trick H update :168-178).

Design notes
------------
The reference's inner loop has a *data-dependent trip count per row*: each row
greedily applies its best coordinate until the best score drops below
``nu * p_init`` or ``k^2`` steps.  The rows are mutually independent, so we
``vmap`` a bounded ``lax.while_loop`` over the rows — JAX's batching rule
masks finished rows automatically, so every row follows exactly the
reference's schedule while the device executes all rows in lockstep (run
length = the slowest row, each step being elementwise work on k-vectors).

The Gram setup (``P = H H'``, ``Z = X H'``, ``G = W P - Z + lambda``) is
plain matmuls; with X sharded it is a k x k all-reduce plus sharded
matmuls, and the per-row loop is local to each row shard.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import matops
from ..ops.objectives import mse_objective
from ..utils.dtypes import eps as _eps
from ..utils.numeric import projectnn
from .common import Result, data_field, nmf_skeleton, register_solver, static_field

__all__ = ["GreedyCD"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GreedyCD:
    """Options for greedy CD (reference ``GreedyCD{T}``, src/greedycd.jl:10-31).
    ``lambda_w``/``lambda_h`` are **L1** coefficients."""

    maxiter: int = static_field(default=100)
    verbose: bool = static_field(default=False)
    tol: float | None = data_field(default=None)
    update_H: bool = static_field(default=True)
    lambda_w: float = data_field(default=0.0)
    lambda_h: float = data_field(default=0.0)

    def __post_init__(self):
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


class _RowCarry(NamedTuple):
    delta: jax.Array  # accumulated coordinate steps for this row ("Wnew")
    G: jax.Array  # this row's gradient
    S: jax.Array  # proposed steps
    D: jax.Array  # score of each proposed step
    qi: jax.Array  # current best coordinate
    it: jax.Array


def _scores(w_row, G_row, denom, Pdiag, dt):
    """S[r] = max(0, w - G/ (eps + P[r,r])) - w;  D[r] = -G*S - 0.5*P[r,r]*S^2
    (src/greedycd.jl:125-131)."""
    zero = jnp.zeros((), dt)
    S = jnp.maximum(zero, w_row - G_row / denom) - w_row
    D = -G_row * S - jnp.asarray(0.5, dt) * Pdiag * S * S
    return S, D


# Lockstep-mitigation knobs: the vmapped while_loop runs EVERY row for the
# slowest row's trip count.  Counted on the config4 problem (163k x 59k,
# k=128; benchmarks/greedycd_trips.py): per-sweep max trips are 136-192 (the
# k^2 cap never binds) while the mean collapses to 3-9 after two sweeps —
# ~40x wasted full-width work.  Fix: an adaptive *compaction
# cascade*.  Masked full-width steps run only while the active-row count
# exceeds the next (1/shrink-sized) buffer; then the still-active rows are
# gathered into that buffer and the loop continues there, shrinking again as
# rows finish, down to a floor of ``min`` rows.  The schedule adapts to the
# data: early sweeps (everyone needs ~150 trips) stay at full width, late
# sweeps (mean ~3, max ~136) collapse to a tiny buffer after a few steps.
# Per-row arithmetic is identical (inactive rows add exact zeros, so their
# carry is a fixed point of the masked step), hence results match the plain
# vmapped loop bit-for-bit.  Knob values live in ``config.greedycd_cascade``
# (env-seeded: NMF_TPU_CASCADE_SHRINK/_MIN/_OFF_ROWS) and are read at trace
# time — benchmarks sweep them in fresh processes.


def _halfstep(X, W, Ht, lam):
    """Update ``W`` (rows x k) holding the other factor ``Ht`` (cols x k)
    fixed — the reference's ``_update_GreedyCD!`` (src/greedycd.jl:94-166).

    Above ``config.greedycd_cascade["slab_rows"]`` rows, the update runs as
    a sequential ``lax.map`` over row slabs: the full-width G/S/D scratch
    is 4 (rows x k) f32 arrays (8 GB at the 2M x 256 config6 slab), while
    rows are mutually independent given the
    shared Grams, so slabbing only needs the global ``p_init`` agreed first
    (a masked max over a scoring pass).  Per-row schedules — and therefore
    results — are bit-identical to the full-width path (pinned in
    tests/test_greedycd.py)."""
    dt = W.dtype
    rows, k = W.shape
    epsT = jnp.asarray(_eps(dt), dt)

    P = Ht.T @ Ht  # (k, k)
    Z = matops.mm(X, Ht)  # (rows, k)
    Pdiag = jnp.diagonal(P)
    denom = epsT + Pdiag
    lam_ = jnp.asarray(lam, dt)
    nu = jnp.asarray(0.001, dt)
    max_inner = k * k

    from .. import config

    slab_max = config.greedycd_cascade["slab_rows"]
    if rows <= slab_max:
        G = W @ P - Z + lam_
        S, D = _scores(W, G, denom, Pdiag, dt)
        # p_init = max(-1, max_i D[i, q_i]) (src/greedycd.jl:132-137)
        p_init = jnp.maximum(jnp.asarray(-1.0, dt), jnp.max(D))
        delta = _greedy_rows(
            W, G, S, D, jnp.zeros((rows,), jnp.int32), P, denom, Pdiag,
            nu * p_init, max_inner, dt,
        )
        return projectnn(W + delta)

    # Sequential slab sweep with dynamic slices — no padded/stacked copies
    # of W and Z (a lax.map over pre-reshaped slabs costs 3 extra (rows, k)
    # buffers).  The LAST slab starts at rows - slab and overlaps the
    # previous one: overlapped rows run the identical schedule twice and
    # the second write stores identical values, so results stay bit-exact.
    ns = -(-rows // slab_max)
    slab = -(-rows // ns)

    def start_of(i):
        return jnp.minimum(i * slab, rows - slab)

    def slab_scores(w, z):
        G = w @ P - z + lam_
        S, D = _scores(w, G, denom, Pdiag, dt)
        return G, S, D

    def pass1(i, acc):
        s0 = start_of(i)
        w = jax.lax.dynamic_slice_in_dim(W, s0, slab)
        z = jax.lax.dynamic_slice_in_dim(Z, s0, slab)
        _, _, D = slab_scores(w, z)
        return jnp.maximum(acc, jnp.max(D))

    p_init = jnp.maximum(
        jnp.asarray(-1.0, dt),
        jax.lax.fori_loop(0, ns, pass1, jnp.asarray(-jnp.inf, dt)),
    )
    threshold = nu * p_init

    def pass2(i, delta_acc):
        s0 = start_of(i)
        w = jax.lax.dynamic_slice_in_dim(W, s0, slab)
        z = jax.lax.dynamic_slice_in_dim(Z, s0, slab)
        G, S, D = slab_scores(w, z)
        delta = _greedy_rows(
            w, G, S, D, jnp.zeros((slab,), jnp.int32), P, denom, Pdiag,
            threshold, max_inner, dt,
        )
        return jax.lax.dynamic_update_slice_in_dim(delta_acc, delta, s0, 0)

    delta_full = jax.lax.fori_loop(
        0, ns, pass2, jnp.zeros((rows, k), dt)
    )
    return projectnn(W + delta_full)


def _greedy_rows(W, G, S, D, it0, P, denom, Pdiag, threshold, max_inner, dt):
    """Every row's greedy coordinate schedule from the given initial scores
    (rows with ``it0 == max_inner`` never step); returns the accumulated
    per-row deltas.  Runs the compaction cascade above the ``off_rows``
    knob, the plain vmapped bounded while_loop below it."""
    rows, k = W.shape

    def row_solve(w_row, c0: _RowCarry):
        """Continue one row's greedy schedule from an existing carry."""

        def cond(c: _RowCarry):
            return jnp.logical_and(c.it < max_inner, c.D[c.qi] >= threshold)

        def body(c: _RowCarry):
            step = c.S[c.qi]
            delta = c.delta.at[c.qi].add(step)
            G_new = c.G + step * P[c.qi, :]
            S_new, D_new = _scores(w_row, G_new, denom, Pdiag, dt)
            return _RowCarry(delta, G_new, S_new, D_new, jnp.argmax(D_new), c.it + 1)

        return jax.lax.while_loop(cond, body, c0)

    init = _RowCarry(
        jnp.zeros((rows, k), dt), G, S, D, jnp.argmax(D, axis=1), it0,
    )

    from .. import config

    knobs = config.greedycd_cascade
    shrink, cascade_min = knobs["shrink"], knobs["min"]
    if rows < knobs["off_rows"]:
        return jax.vmap(row_solve)(W, init).delta

    def masked_machinery(Wsub):
        """Masked full-width step over a buffer of rows (carry shapes match
        ``Wsub``).  Inactive rows add exact zeros: delta and G are unchanged,
        so the recomputed S/D/qi — and therefore the whole carry — are a
        fixed point; every row follows exactly the reference's schedule."""
        nr = Wsub.shape[0]
        ar = jnp.arange(nr)

        def active_mask(c: _RowCarry):
            return (c.it < max_inner) & (c.D[ar, c.qi] >= threshold)

        def step(c: _RowCarry):
            active = active_mask(c)
            sv = jnp.where(active, c.S[ar, c.qi], jnp.zeros((), dt))
            delta = c.delta.at[ar, c.qi].add(sv)
            G_new = c.G + sv[:, None] * P[c.qi, :]
            S_new, D_new = _scores(Wsub, G_new, denom, Pdiag, dt)
            return _RowCarry(
                delta, G_new, S_new, D_new, jnp.argmax(D_new, axis=1),
                c.it + active.astype(jnp.int32),
            )

        return active_mask, step

    # Static buffer sizes: rows, rows/shrink, rows/shrink^2, ... down to
    # the cascade floor.
    caps = []
    cur = rows
    while cur // shrink >= cascade_min:
        cur = cur // shrink
        caps.append(cur)

    delta_full = jnp.zeros((rows, k), dt)
    idx = None  # level-0 buffer is the identity mapping
    carry = init
    Wsub = W
    for next_cap in caps:
        active_mask, step = masked_machinery(Wsub)

        def level_cond(c, am=active_mask, nc=next_cap):
            return jnp.sum(am(c)) > nc

        carry = jax.lax.while_loop(level_cond, step, carry)
        # checkpoint this level's deltas (rows finishing here keep them);
        # fill slots carry idx == rows and are dropped by the OOB scatter
        if idx is None:
            delta_full = carry.delta
        else:
            delta_full = delta_full.at[idx].set(carry.delta, mode="drop")
        # compact the still-active rows into the next (smaller) buffer
        act = active_mask(carry)
        nr = Wsub.shape[0]
        (loc,) = jnp.nonzero(act, size=next_cap, fill_value=nr)
        fill = loc >= nr
        safe = jnp.minimum(loc, nr - 1)
        carry = jax.tree_util.tree_map(lambda a: a[safe], carry)
        # freeze fill slots (duplicate a real row's carry but never step)
        carry = carry._replace(
            it=jnp.where(fill, jnp.asarray(max_inner, jnp.int32), carry.it)
        )
        idx = jnp.where(fill, rows, loc if idx is None else idx[safe])
        Wsub = W[jnp.minimum(idx, rows - 1)]

    # final (smallest) level: run until every row is finished
    active_mask, step = masked_machinery(Wsub)
    carry = jax.lax.while_loop(lambda c: jnp.any(active_mask(c)), step, carry)
    if idx is None:
        delta_full = carry.delta
    else:
        delta_full = delta_full.at[idx].set(carry.delta, mode="drop")
    return delta_full


def _prepare(upd: GreedyCD, X, W, H):
    return ()


def _update(upd: GreedyCD, state, X, W, H):
    W = _halfstep(X, W, H.T, upd.lambda_w)
    if upd.update_H:
        H = _halfstep(matops.transpose(X), H.T, W, upd.lambda_h).T
    return W, H, state


def _objective(upd: GreedyCD, state, X, W, H):
    """0.5||X-WH||^2 + lambda_w*||W||_1 + lambda_h*||H||_1
    (src/greedycd.jl:80-92)."""
    dt = W.dtype
    r = mse_objective(X, W, H)
    r = r + jnp.asarray(upd.lambda_w, dt) * jnp.sum(jnp.abs(W))
    r = r + jnp.asarray(upd.lambda_h, dt) * jnp.sum(jnp.abs(H))
    return r


register_solver(GreedyCD, prepare=_prepare, update=_update,
                objective=_objective)
