"""Benchmark harness — prints ONE JSON line.

Headline metric: **wall seconds to a fixed relative reconstruction error**
on the sparse flagship config — BASELINE.md's stated metric
("iterations/sec + wall-time-to-tol") on the MovieLens-25M-shaped problem
(163k x 59k power-law sparse, ~17.6M nnz, rank 128, Fast-HALS).
``vs_baseline`` is the speedup over the reference-equivalent CPU
implementation: the same exact-semantics Fast-HALS sweep (scipy.sparse CSR
products + the sequential per-component Newton loop of
/root/reference/src/coorddesc.jl:109-159) timed per iteration and
extrapolated to the measured run's iteration count — HALS is
deterministic, so iterations-to-target match and the time ratio equals the
rate ratio.  The dense 500x500 rank-8 MU-MSE rate is kept as the ``c1_*``
fields.

The row names the device it ran on (``platform``, ``device_kind``,
``device_count``).  Without a GPU the harness exits non-zero before
measuring, unless the caller asked for the CPU with ``JAX_PLATFORMS=cpu``.
The c1 rate is differential (N_big - N_small iterations over the elapsed
delta, each run ended by a device-to-host readback), which cancels the
fixed per-call dispatch and readback cost; the time-to-tol loop includes
its per-chunk relerr readback as part of the honest cost of checking.
"""

import json
import os
import sys
import time

import numpy as np

P, N, K = 500, 500, 8
DTYPE = np.float32
N_SMALL, N_BIG = 100, 2100


def numpy_mu_baseline(X, W, H, iters):
    """Reference-equivalent MU-MSE loop on CPU BLAS (same math as
    src/multupd.jl:96-115 with the Gram-form matmuls + stop test)."""
    delta = np.sqrt(np.finfo(DTYPE).eps).astype(DTYPE)
    tol = DTYPE(1e-30)
    t0 = time.perf_counter()
    for _ in range(iters):
        preW, preH = W.copy(), H.copy()
        WtX = W.T @ X
        WtWH = (W.T @ W) @ H
        H = H * (np.maximum(0, WtX) / (WtWH + delta))
        XHt = X @ H.T
        WHHt = W @ (H @ H.T)
        W = W * (np.maximum(0, XHt) / (WHHt + delta))
        dev_w = ((W - preW) ** 2).sum(0)
        sum_w = ((W + preW) ** 2).sum(0)
        dev_h = ((H - preH) ** 2).sum(1)
        sum_h = ((H + preH) ** 2).sum(1)
        if not ((dev_w > tol**2 * sum_w) | (dev_h > tol**2 * sum_h)).any():
            break
    elapsed = time.perf_counter() - t0
    objv = 0.5 * ((X - W @ H) ** 2).sum()
    return iters / elapsed, objv


def numpy_hals_sec_per_iter(Xcsr, W, H, iters=2):
    """Exact-semantics Fast-HALS sweep on scipy.sparse CSR — the CPU
    performance layer the Julia reference sits on (sparse mul! + the
    strictly sequential per-component scalar loop,
    src/coorddesc.jl:109-175).  Returns measured seconds per iteration."""
    k = W.shape[1]
    Ht = np.ascontiguousarray(H.T)
    t0 = time.perf_counter()
    for _ in range(iters):
        HHt = Ht.T @ Ht
        XHt = np.asarray(Xcsr @ Ht)
        for t in range(k):
            grad = W @ HHt[:, t] - XHt[:, t]
            W[:, t] = np.maximum(W[:, t] - grad / (HHt[t, t] or 1.0), 0.0)
        WtW = W.T @ W
        XtW = np.asarray(Xcsr.T @ W)
        for t in range(k):
            grad = Ht @ WtW[:, t] - XtW[:, t]
            # dead components (diag 0) skip their update, like the sklearn
            # guard the reference ports; `or 1.0` keeps the flop count
            Ht[:, t] = np.maximum(Ht[:, t] - grad / (WtW[t, t] or 1.0), 0.0)
    return (time.perf_counter() - t0) / iters


def measure_c1():
    """Dense 500x500 rank-8 MU-MSE iterations/sec (the former headline)."""
    import jax.numpy as jnp

    from nmf_tpu.models.common import _solve_while
    from nmf_tpu.models.multupd import MultUpdate

    rng = np.random.default_rng(0)
    X = rng.random((P, N), dtype=DTYPE)
    W0 = rng.random((P, K), dtype=DTYPE)
    H0 = rng.random((K, N), dtype=DTYPE)

    upd = MultUpdate(obj="mse")
    Xd, Wd, Hd = jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0)
    tol = jnp.asarray(1e-30, DTYPE)

    def run(iters):
        t0 = time.perf_counter()
        out = _solve_while(upd, Xd, Wd, Hd, jnp.asarray(iters, jnp.int32), tol)
        objv = float(out[4])  # forced device->host readback
        return time.perf_counter() - t0, objv, int(out[2])

    run(2)  # compile + warm (maxiter is traced: same executable)
    t_small = min(run(N_SMALL)[0] for _ in range(3))
    t_big, _objv, niters = min(run(N_BIG) for _ in range(3))
    assert niters == N_BIG, f"early exit at {niters}"
    its_per_sec = (N_BIG - N_SMALL) / (t_big - t_small)

    base_its, objv_np = numpy_mu_baseline(X.copy(), W0.copy(), H0.copy(), N_SMALL)
    out100 = _solve_while(upd, Xd, Wd, Hd, jnp.asarray(N_SMALL, jnp.int32), tol)
    rel = abs(float(out100[4]) - float(objv_np)) / max(float(objv_np), 1e-30)
    assert rel < 0.05, f"convergence mismatch vs baseline at {N_SMALL} iters: {rel}"
    return round(its_per_sec, 2), round(its_per_sec / base_its, 2)


def measure_ttt4():
    """Sparse flagship time-to-tol (benchmarks/run.py ttt4) + the
    reference-equivalent numpy extrapolation."""
    import scipy.sparse

    from benchmarks import run as bench_suite

    res = bench_suite.ttt4()
    # reproduce ttt4's exact problem (same generator, same seed) for the
    # CPU baseline
    rng = np.random.default_rng(0)
    p, n, k = 163_000, 59_000, 128
    rows, cols, vals = bench_suite._movielens_like(rng)
    Xcsr = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(p, n))
    W = rng.random((p, k), dtype=np.float32)
    H = rng.random((k, n), dtype=np.float32)
    sec_per_iter = numpy_hals_sec_per_iter(Xcsr, W, H)
    numpy_est = sec_per_iter * res["cd"]["iters"]
    return res, round(numpy_est, 3)


def main():
    from benchmarks.run import require_gpu
    from nmf_tpu import config

    device = require_gpu()
    config.enable_compilation_cache()
    c1_rate, c1_vs = measure_c1()
    res, numpy_est = measure_ttt4()
    print(json.dumps({
        "metric": "ttt4_hals_sparse_163kx59k_k128_sec_to_tol",
        "value": res["cd"]["sec"],
        "unit": res["unit"],
        "vs_baseline": round(numpy_est / max(res["cd"]["sec"], 1e-9), 2),
        "hals_iters": res["cd"]["iters"],
        "greedycd_sec": res["greedycd"]["sec"],
        "greedycd_iters": res["greedycd"]["iters"],
        "nnz": res["nnz"],
        "numpy_hals_est_sec": numpy_est,
        "c1_mu_mse_iters_per_sec": c1_rate,
        "c1_vs_numpy": c1_vs,
        **device,
    }))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
