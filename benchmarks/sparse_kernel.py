"""Sparse product candidates at config4 widths, timed on the GPU.

The config4 matrix is MovieLens-25M-shaped: 163k x 59k, power-law rows and
columns (``run.py:_movielens_like``), about 17.6M nonzeros after dedup, k=128,
stored as ``build_tiled(rows, cols, vals, shape)``.  For each candidate
this script

* times ``X @ D`` (mm), ``X' @ D`` (mtm) and the SDDMM in steady state
  (median of ``--reps`` calls, each ended by ``block_until_ready``);
* checks each result against ``scipy.sparse`` in float64: the error is
  ``max|got - ref| / max|ref|`` and must stay below ``TOL``;
* times one HALS, one GreedyCD and one MU-div iteration through the
  solver loop (``_solve_while``) with each candidate the solvers can take.

Candidates: ``xla_csr`` (the store's products over its sorted CSR-order
entries, ``nmf_tpu.ops.tiled.csr_product``, and the plain SDDMM
``sddmm_kernel.sddmm_reference``), ``triton_sddmm`` (the Pallas-Triton SDDMM,
``sddmm_kernel.sddmm_triton``, at several block sizes), ``bcoo``
(``jax.experimental.sparse`` BCOO, XLA lowering) and ``bcoo_cusparse``
(the same with ``jax_bcoo_cusparse_lowering``).  Every candidate runs under
``default_matmul_precision("highest")``, the solvers' policy.

Usage::

    python benchmarks/sparse_kernel.py [--small --interpret] [--reps N] [--out FILE]

``--small`` shrinks the matrix for a CPU rehearsal (``JAX_PLATFORMS=cpu``),
and ``--interpret`` runs the Triton kernel in the Pallas interpreter there.
Each measurement prints one JSON line, which names the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-5  # max|got - ref| / max|ref| against float64 scipy
# (block, num_warps) of the Triton SDDMM; the first is the library default
TRITON_CONFIGS = ((32, 4), (64, 4), (64, 8), (16, 4))


def _gpu_name():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _steady(fn, args, reps):
    """(median seconds, result) of ``fn(*args)`` after two warm-up calls."""
    import jax

    out = jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def _err(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _iteration_time(upd, X, W, H, iters, reps):
    """Seconds per solver iteration: (t(1 + iters) - t(1)) / iters, both
    warm, each the median of ``reps`` runs."""
    import jax.numpy as jnp

    from nmf_tpu import config
    from nmf_tpu.models.common import _solve_while

    tol = jnp.asarray(0.0, W.dtype)  # never converge: run every iteration

    def run(n):
        return _solve_while(upd, X, W, H, jnp.asarray(n, jnp.int32), tol)

    with config.precision_scope(config.solver_precision(upd)):
        t1, _ = _steady(run, (1,), reps)
        tn, out = _steady(run, (1 + iters,), reps)
    return (tn - t1) / iters, float(out[4])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--skip-solvers", action="store_true")
    ap.add_argument("--skip-bcoo", action="store_true",
                    help="leave out the BCOO candidates")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import scipy.sparse
    from jax.experimental import sparse as jsparse

    from nmf_tpu import config
    from nmf_tpu.models.coorddesc import CoordinateDescent
    from nmf_tpu.models.greedycd import GreedyCD
    from nmf_tpu.models.multupd import MultUpdate
    from nmf_tpu.ops import tiled
    from nmf_tpu.ops.sddmm_kernel import sddmm_reference, sddmm_triton
    from nmf_tpu.ops.sparse_format import build_tiled
    from nmf_tpu.ops.tiled import tiled_mm, tiled_mtm

    from benchmarks.run import _movielens_like, require_gpu

    dev = require_gpu()
    config.enable_compilation_cache()
    print(f"# card: {_gpu_name()}", flush=True)
    rows_out = []

    def emit(**kw):
        kw["device"] = dev
        print(json.dumps(kw), flush=True)
        rows_out.append(kw)

    rng = np.random.default_rng(0)
    if args.small:
        p, n, k, draws = 3000, 1500, 16, 60_000
    else:
        p, n, k, draws = 163_000, 59_000, 128, 25_000_000
    t0 = time.perf_counter()
    rows, cols, vals = _movielens_like(rng, p, n, draws)
    X = build_tiled(rows, cols, vals, (p, n))
    emit(phase="build", nnz=len(vals), sec=time.perf_counter() - t0)

    ref_csr = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)),
                                      shape=(p, n))
    D = rng.random((n, k), dtype=np.float32)
    E = rng.random((p, k), dtype=np.float32)
    Wf = rng.random((p, k), dtype=np.float32)
    Hf = rng.random((k, n), dtype=np.float32)
    ref = {
        "mm": ref_csr @ D.astype(np.float64),
        "mtm": ref_csr.T @ E.astype(np.float64),
        "sddmm": np.einsum("ik,ik->i", Wf.astype(np.float64)[rows],
                           Hf.T.astype(np.float64)[cols]),
    }
    Dj, Ej, Wj, Hj = map(jnp.asarray, (D, E, Wf, Hf))
    r_j, c_j, v_j = X.row_idx, X.col_idx, X.values
    Xb = jsparse.BCOO((v_j, jnp.stack([r_j, c_j], 1)), shape=(p, n),
                      indices_sorted=True, unique_indices=True)

    def bcoo_mm(Xb, D):
        return jsparse.bcoo_dot_general(Xb, D, dimension_numbers=(((1,), (0,)), ((), ())))

    def bcoo_mtm(Xb, D):
        return jsparse.bcoo_dot_general(Xb, D, dimension_numbers=(((0,), (0,)), ((), ())))

    def bcoo_sddmm(Xb, W, H):
        return jsparse.bcoo_dot_general_sampled(
            W, H, Xb.indices, dimension_numbers=(((1,), (0,)), ((), ())))

    def triton(block, warps):
        def f(rows, cols, W, Ht):
            return sddmm_triton(rows, cols, W, Ht, block=block,
                                num_warps=warps, interpret=args.interpret)
        return f

    bcoo_ops = {"mm": (bcoo_mm, (Xb, Dj)), "mtm": (bcoo_mtm, (Xb, Ej)),
                "sddmm": (bcoo_sddmm, (Xb, Wj, Hj))}
    cands = {
        "xla_csr": {
            "mm": (tiled_mm, (X, Dj)),
            "mtm": (tiled_mtm, (X, Ej)),
            "sddmm": (sddmm_reference, (r_j, c_j, Wj, Hj.T)),
        },
    }
    for cfg in TRITON_CONFIGS:
        cands["triton_sddmm_b%d_w%d" % cfg] = {
            "sddmm": (triton(*cfg), (r_j, c_j, Wj, Hj.T))}
    if not args.skip_bcoo:
        cands["bcoo"] = bcoo_ops
        cands["bcoo_cusparse"] = bcoo_ops

    failures = 0
    with jax.default_matmul_precision("highest"):
        for name, ops in cands.items():
            jax.config.update("jax_bcoo_cusparse_lowering", name == "bcoo_cusparse")
            for op, (fn, fargs) in ops.items():
                static = ()
                try:
                    # a fresh function per candidate: no compiled program
                    # is shared across the cuSPARSE flag
                    sec, out = _steady(
                        jax.jit(lambda *a, f=fn: f(*a), static_argnums=static),
                        fargs, args.reps)
                except Exception as e:  # report the candidate, go on
                    failures += 1
                    emit(phase="product", candidate=name, op=op,
                         error=f"{type(e).__name__}: {str(e)[:300]}")
                    continue
                err = _err(out, ref[op])
                failures += err > TOL
                emit(phase="product", candidate=name, op=op, sec=sec,
                     err=err, tol=TOL, ok=err <= TOL,
                     gnnz_per_sec=len(vals) / sec / 1e9)
                del out
        jax.config.update("jax_bcoo_cusparse_lowering", False)

    if not args.skip_solvers:
        W0 = jnp.asarray(rng.random((p, k), dtype=np.float32))
        H0 = jnp.asarray(rng.random((k, n), dtype=np.float32))
        algs = {"hals": CoordinateDescent(maxiter=100)._resolved(np.float32)[0],
                "greedycd": GreedyCD(maxiter=100)._resolved(np.float32)[0],
                "multdiv": MultUpdate(obj="div", maxiter=100)}
        seam = tiled.entries_sddmm
        runs = [("xla_csr", X, sddmm_reference, list(algs)),
                ("triton_sddmm_b%d_w%d" % TRITON_CONFIGS[0], X,
                 triton(*TRITON_CONFIGS[0]), ["multdiv"])]
        if not args.skip_bcoo:
            runs += [("bcoo", Xb, seam, list(algs)),
                     ("bcoo_cusparse", Xb, seam, list(algs))]
        for name, Xin, sddmm, names in runs:
            jax.config.update("jax_bcoo_cusparse_lowering", name == "bcoo_cusparse")
            tiled.entries_sddmm = sddmm  # the SDDMM the solvers' seam runs
            jax.clear_caches()
            for aname in names:
                try:
                    sec, obj = _iteration_time(algs[aname], Xin, W0, H0, 3,
                                               max(3, args.reps // 3))
                except Exception as e:
                    failures += 1
                    emit(phase="iteration", candidate=name, alg=aname,
                         error=f"{type(e).__name__}: {str(e)[:300]}")
                    continue
                emit(phase="iteration", candidate=name, alg=aname,
                     sec_per_iter=sec, objective_after_4=obj)
        tiled.entries_sddmm = seam
        jax.config.update("jax_bcoo_cusparse_lowering", False)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows_out:
                f.write(json.dumps(r) + "\n")
    if failures:
        sys.exit(f"{failures} candidate(s) failed or exceeded the tolerance")


if __name__ == "__main__":
    main()
