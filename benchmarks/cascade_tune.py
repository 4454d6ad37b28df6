"""Sweep the GreedyCD compaction-cascade knobs on the config4 problem.

The knobs (``nmf_tpu.config.greedycd_cascade``) are read at trace time and
the solve loop is a module-level ``@jax.jit``, so each combo must run in a
fresh process — this driver sets NMF_TPU_CASCADE_* and re-execs itself as a
worker per combo.  The 25M-draw problem generation is cached to an npz so
only the tiled build (~seconds) is paid per worker.

    python benchmarks/cascade_tune.py                       # default grid
    python benchmarks/cascade_tune.py --grid 4:1024,8:512   # shrink:min list

Prints one JSON line per combo: {"shrink":…, "min":…, "greedycd_iters_per_sec":…}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)

CACHE = "/tmp/cascade_tune_problem.npz"


def _problem():
    from run import _movielens_like

    if os.path.exists(CACHE):
        d = np.load(CACHE)
        return d["rows"], d["cols"], d["vals"]
    rng = np.random.default_rng(0)
    rows, cols, vals = _movielens_like(rng)
    np.savez(CACHE, rows=rows, cols=cols, vals=vals)
    return rows, cols, vals


def worker(args):
    import jax.numpy as jnp

    from nmf_tpu import config
    from nmf_tpu.models.greedycd import GreedyCD
    from nmf_tpu.ops.sparse_format import build_tiled
    from run import _solver_rate

    rows, cols, vals = _problem()
    p, n, k = 163_000, 59_000, 128
    X = build_tiled(rows, cols, vals, (p, n))
    rng = np.random.default_rng(1)
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))
    g, _ = GreedyCD(maxiter=100)._resolved(np.float32)
    rate = _solver_rate(g, X, W, H, 2, 6)
    print(json.dumps({
        "metric": "cascade_tune_config4_greedycd",
        "shrink": config.greedycd_cascade["shrink"],
        "min": config.greedycd_cascade["min"],
        "greedycd_iters_per_sec": round(rate, 3),
        "unit": "iterations/sec",
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="4:1024,2:1024,8:1024,4:256,4:4096")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    _problem()  # populate the cache once, outside any timing
    for combo in args.grid.split(","):
        shrink, floor = combo.split(":")
        env = dict(os.environ)
        env["NMF_TPU_CASCADE_SHRINK"] = shrink
        env["NMF_TPU_CASCADE_MIN"] = floor
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                env=env, cwd=REPO, capture_output=True, text=True,
                timeout=3600,
            )
        except subprocess.TimeoutExpired:
            print(json.dumps({
                "error": "timeout",
                "shrink": int(shrink), "min": int(floor),
            }), flush=True)
            continue
        printed = False
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
                printed = True
        if not printed:
            print(json.dumps({
                "error": (out.stdout + out.stderr)[-500:],
                "shrink": int(shrink), "min": int(floor),
            }), flush=True)


if __name__ == "__main__":
    main()
