"""Matmul-precision sweep across the solver zoo.

Measures, per solver x jax matmul precision ("default" = the backend's
choice, "tensorfloat32" = TF32 tensor cores on a GPU, "highest" = exact
float32, the solvers' default), on a dense exact-rank problem:

* convergence floor — final relative reconstruction error
  ||X - WH||_F / ||X||_F after a fixed iteration budget (tol=1e-30, no early
  exit), computed on host in f64;
* speed — iterations/sec, differential (big - small iteration counts) to
  cancel the fixed dispatch and readback cost of each call.

The results are the evidence for trading the convergence floor for speed
with ``nmf_tpu.config.set_matmul_precision`` (see docs/precision.md).  Run
on the GPU from the repository root:

    python benchmarks/precision_sweep.py [solver ...]

Solvers: mu_mse mu_div projals cd greedycd alspgrad (default: all).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

P, N, K = 2000, 1000, 32
DTYPE = np.float32

PRECISIONS = ["default", "tensorfloat32", "highest"]

# (name, alg-factory, probe-iters, floor-iters)
CONFIGS = {
    "mu_mse": (lambda M: M.MultUpdate(obj="mse", tol=1e-30), 100, 2000),
    "mu_div": (lambda M: M.MultUpdate(obj="div", tol=1e-30), 50, 1000),
    "projals": (lambda M: M.ProjectedALS(tol=1e-30), 50, 300),
    "cd": (lambda M: M.CoordinateDescent(tol=1e-30, shuffle=False), 50, 300),
    "greedycd": (lambda M: M.GreedyCD(tol=1e-30), 20, 150),
    "alspgrad": (lambda M: M.ALSPGrad(tol=1e-30), 5, 50),
}

TARGET_DELTA_S = 0.8  # aim the differential window well above timing noise


def main(argv):
    import jax
    import jax.numpy as jnp

    import nmf_tpu
    from nmf_tpu import config

    names = argv or list(CONFIGS)
    rng = np.random.default_rng(7)
    Wg = rng.random((P, K)).astype(np.float64)
    Hg = rng.random((K, N)).astype(np.float64)
    X64 = Wg @ Hg
    X = X64.astype(DTYPE)
    normX = np.linalg.norm(X64)
    W0 = (Wg + 0.1 * rng.random((P, K))).astype(DTYPE)
    H0 = (Hg + 0.1 * rng.random((K, N))).astype(DTYPE)

    Xd, W0d, H0d = jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0)

    results = []
    for name in names:
        factory, n_probe, n_floor = CONFIGS[name]
        for prec in PRECISIONS:
            config.set_matmul_precision(prec)

            def run(iters):
                import dataclasses

                alg = factory(nmf_tpu)
                alg = dataclasses.replace(alg, maxiter=iters)
                t0 = time.perf_counter()
                ret = nmf_tpu.solve(alg, Xd, W0d, H0d)
                # Result construction already forced host readback of objv.
                return time.perf_counter() - t0, ret

            t_over, _ = run(2)  # compile (maxiter is traced for all solvers)
            t_over = min(t_over, run(2)[0])  # warm dispatch+readback overhead
            # Calibrate: pick a big count whose *extra* time >> timing noise.
            t_probe = min(run(n_probe)[0] for _ in range(2))
            per_iter = max((t_probe - t_over) / (n_probe - 2), 1e-7)
            # cap the window at 30k extra iterations
            n_big = n_probe + min(max(2 * n_probe, int(TARGET_DELTA_S / per_iter)), 30000)
            t_small = t_probe
            t_big, ret = min(run(n_big) for _ in range(2))
            its = (n_big - n_probe) / (t_big - t_small)
            # Floor: fixed budget so precisions are comparable.
            _, ret_floor = run(n_floor)
            relerr = float(
                np.linalg.norm(
                    X64 - np.asarray(ret_floor.W, np.float64) @ np.asarray(ret_floor.H, np.float64)
                )
                / normX
            )
            row = {
                "solver": name,
                "precision": prec,
                "iters_per_sec": round(its, 2),
                "relerr": float(f"{relerr:.3e}"),
                "floor_iters": n_floor,
                "timed_iters": n_big,
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    config.set_matmul_precision(None)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
