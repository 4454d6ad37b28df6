"""GreedyCD inner-loop trip-count probe (VERDICT r1 item 8).

The vmapped bounded while_loop in ``models/greedycd.py`` executes every row
for the slowest row's trip count (JAX batching lowers vmapped while_loops to
a single loop with an any() condition) — the cap is k^2 per sweep.  This
probe measures the actual per-row trip distribution on the config4-style
problem so the lockstep cost is quantified instead of assumed.

Usage: python benchmarks/greedycd_trips.py [--sweeps 5] [--k 128]
Prints one JSON line per sweep with the distribution of row trip counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--rows", type=int, default=0, help="row subsample (0=all)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks.run import _movielens_like
    from nmf_tpu.models.greedycd import _RowCarry, _scores
    from nmf_tpu.ops import matops
    from nmf_tpu.ops.sparse_format import build_tiled
    from nmf_tpu.utils.dtypes import eps as _eps
    from nmf_tpu.utils.numeric import projectnn

    rng = np.random.default_rng(0)
    p, n, k = 163_000, 59_000, args.k
    rows, cols, vals = _movielens_like(rng)
    X = build_tiled(rows, cols, vals, (p, n))
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))

    dt = jnp.float32
    epsT = jnp.asarray(_eps(dt), dt)

    def halfstep_with_trips(X, W, Ht, rows_cap):
        P = Ht.T @ Ht
        Z = matops.mm(X, Ht)
        G = W @ P - Z
        Pdiag = jnp.diagonal(P)
        denom = epsT + Pdiag
        S = jnp.maximum(0.0, W - G / denom) - W
        D = -G * S - 0.5 * Pdiag * S * S
        q0 = jnp.argmax(D, axis=1)
        p_init = jnp.maximum(jnp.asarray(-1.0, dt), jnp.max(D))
        threshold = 0.001 * p_init
        max_inner = k * k

        def row_solve(w_row, G_row, S_row, D_row, qi0):
            def cond(c):
                return jnp.logical_and(c.it < max_inner, c.D[c.qi] >= threshold)

            def body(c):
                step = c.S[c.qi]
                delta = c.delta.at[c.qi].add(step)
                G_new = c.G + step * P[c.qi, :]
                S_new, D_new = _scores(w_row, G_new, denom, Pdiag, dt)
                return _RowCarry(
                    delta, G_new, S_new, D_new, jnp.argmax(D_new), c.it + 1
                )

            init = _RowCarry(
                jnp.zeros((k,), dt), G_row, S_row, D_row, qi0,
                jnp.zeros((), jnp.int32),
            )
            out = jax.lax.while_loop(cond, body, init)
            return out.delta, out.it

        sel = slice(None) if not rows_cap else slice(0, rows_cap)
        delta, trips = jax.vmap(row_solve)(W[sel], G[sel], S[sel], D[sel], q0[sel])
        Wn = projectnn(W[sel] + delta)
        return Wn, trips

    step = jax.jit(halfstep_with_trips, static_argnames=("rows_cap",))

    for sweep in range(args.sweeps):
        Wn, trips_w = step(X, W, H.T, args.rows)
        if not args.rows:
            W = Wn
        Hn, trips_h = step(matops.transpose(X), H.T, W, args.rows)
        if not args.rows:
            H = Hn.T
        tw = np.asarray(trips_w)
        th = np.asarray(trips_h)
        print(
            json.dumps(
                {
                    "sweep": sweep,
                    "k2_cap": k * k,
                    "W": {
                        "max": int(tw.max()),
                        "p99": int(np.percentile(tw, 99)),
                        "median": int(np.median(tw)),
                        "mean": round(float(tw.mean()), 1),
                    },
                    "H": {
                        "max": int(th.max()),
                        "p99": int(np.percentile(th, 99)),
                        "median": int(np.median(th)),
                        "mean": round(float(th.mean()), 1),
                    },
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
