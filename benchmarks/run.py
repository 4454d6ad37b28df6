"""Benchmark suite over the BASELINE.json configs.

Usage: python benchmarks/run.py [config1 config2 ... | all]

Each config prints one JSON line: {"metric", "value", "unit", ...extras},
with the device it ran on (``platform``, ``device_kind``, ``device_count``).
Without a GPU the suite exits non-zero before measuring, unless the caller
asked for the CPU with ``JAX_PLATFORMS=cpu``.  It exits non-zero when any
requested config failed.  Rates are differential (run N_small and N_big
in-graph iterations, divide the elapsed delta, with a forced device-to-host
readback), which cancels the fixed dispatch and readback cost per call.

Configs (BASELINE.json):
  1. dense 500x500, k=8, MU-MSE, random init
  2. dense 2000x1000, k=32, MU-KL (multdiv), NNDSVDar init via randomized SVD
  3. dense 100k x 10k, k=64, ALSPGrad + ProjectedALS
  4. sparse MovieLens-25M-shaped (163k x 59k, ~25M nnz), k=128, HALS cd +
     greedycd on BCOO
  5. weak-scaling of the sharded MU sweep over the devices of one process
     (1 -> all devices)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def require_gpu() -> dict:
    """The device every result row names.  Exits (non-zero, before any
    measurement) when JAX's first device is not a GPU, unless the caller
    asked for the CPU with ``JAX_PLATFORMS=cpu``: JAX falls back to the CPU
    when the CUDA plugin fails to start, and a CPU number must never pass
    for a GPU one."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"no GPU found (JAX platform {dev.platform!r}); set "
                 "JAX_PLATFORMS=cpu to measure on the CPU")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def _timed(fn, n_small, n_big, repeats=3):
    """Differential timing of fn(iters) -> scalar-readback."""
    fn(2)
    t_small = min(_once(fn, n_small) for _ in range(repeats))
    t_big = min(_once(fn, n_big) for _ in range(repeats))
    return (n_big - n_small) / (t_big - t_small)


def _once(fn, iters):
    t0 = time.perf_counter()
    fn(iters)
    return time.perf_counter() - t0


def _solver_rate(upd, X, W, H, n_small, n_big, dtype=np.float32):
    import jax.numpy as jnp

    from nmf_tpu import config as _config
    from nmf_tpu.models.common import _solve_while

    tol = jnp.asarray(1e-30, X.dtype if hasattr(X, "dtype") else dtype)

    def run(iters):
        out = _solve_while(upd, X, W, H, jnp.asarray(iters, jnp.int32), tol)
        float(out[4])

    # the solvers' own precision policy, as nnmf/solve apply it
    with _config.precision_scope(_config.solver_precision(upd)):
        return _timed(run, n_small, n_big)


def _solver_rate_device_init(upd, X, p, n, k, n_small, n_big, seed=0):
    """Like _solver_rate but the random W0/H0 are GENERATED INSIDE the
    jitted program: at capacity scale (config6: 2M x 256) the separate
    W0/H0 operand buffers are 2.25 GB of device memory on top of the
    carry's own copies."""
    import jax
    import jax.numpy as jnp

    from nmf_tpu.models.common import _solve_while

    tol = jnp.asarray(1e-30, jnp.float32)
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def prog(X, key, iters):
        kw, kh = jax.random.split(key)
        W0 = jax.random.uniform(kw, (p, k), jnp.float32)
        H0 = jax.random.uniform(kh, (k, n), jnp.float32)
        return _solve_while(upd, X, W0, H0, iters, tol)

    def run(iters):
        out = prog(X, key, jnp.asarray(iters, jnp.int32))
        float(out[4])

    return _timed(run, n_small, n_big)


def _greedycd_chunked_rate(X, p, n, k, iters=6, slab_rows=131072):
    """Capacity-scale GreedyCD rate via 1-iter-per-dispatch chunking with
    donated carries, so that each iteration is timed on its own and the
    carried W/H/state buffers are not held twice.  Returns
    (mean it/s over the window, steady-state it/s over iters 3+, per-iter
    seconds)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from nmf_tpu import config as _cfg
    from nmf_tpu.models.common import _prepare, _solve_while_from
    from nmf_tpu.models.greedycd import GreedyCD

    saved_slab = _cfg.greedycd_cascade["slab_rows"]
    _cfg.set_greedycd_cascade(slab_rows=slab_rows)
    try:
        g, _ = GreedyCD(maxiter=100)._resolved(np.float32)
        tol = jnp.asarray(1e-30, jnp.float32)

        @jax.jit
        def dev_init(key):
            kw, kh = jax.random.split(key)
            return (jax.random.uniform(kw, (p, k), jnp.float32),
                    jax.random.uniform(kh, (k, n), jnp.float32))

        W, H = dev_init(jax.random.PRNGKey(0))
        state = _prepare(g, X, W, H)

        @partial(jax.jit, donate_argnums=(1, 2, 3))
        def one_iter(X, w, h, st):
            w, h, st, t, _conv, _ = _solve_while_from(
                g, st, X, w, h, 0, jnp.asarray(1, jnp.int32), tol,
                with_objective=False,
            )
            return w, h, st

        W, H, state = one_iter(X, W, H, state)  # compile + iter 1
        float(jnp.sum(H))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            W, H, state = one_iter(X, W, H, state)
            float(jnp.sum(H))
            times.append(time.perf_counter() - t0)
        mean_rate = len(times) / sum(times)
        steady = times[1:] if len(times) > 2 else times
        return mean_rate, len(steady) / sum(steady), times
    finally:
        _cfg.set_greedycd_cascade(slab_rows=saved_slab)


def _time_to_tol(upd, X, W, H, target, chunk=25, max_iters=5000, trajectory=False):
    """Wall time until relative reconstruction error
    ``||X - WH||_F / ||X||_F <= target`` (BASELINE.md's stated metric).

    Chunked resumable solve: ``chunk`` iterations per device dispatch, one
    relerr readback per chunk (the readback round-trip is part of the honest
    cost of checking).  relchange stopping is disabled (tol=1e-30) so the
    solver runs until the quality gate, exactly like a user iterating to a
    target quality.  Compile time is excluded via a warm-up chunk.
    Returns (seconds, iterations, final_relerr)."""
    import jax
    import jax.numpy as jnp

    from nmf_tpu import config as _config
    from nmf_tpu.models.common import _prepare, _solve_while_from
    from nmf_tpu.ops import matops
    from nmf_tpu.ops.objectives import mse_objective

    xsq = float(matops.sq_norm(X))
    tol = jnp.asarray(1e-30, W.dtype)
    mse_j = jax.jit(mse_objective)

    def relerr(w, h):
        return float(jnp.sqrt(jnp.maximum(2.0 * mse_j(X, w, h), 0.0)) / np.sqrt(xsq))

    with _config.precision_scope(_config.solver_precision(upd)):
        state0 = _prepare(upd, X, W, H)
        # warm-up: compile the chunk program + the relerr program
        wu = _solve_while_from(
            upd, state0, X, W, H, 0, jnp.asarray(2, jnp.int32), tol,
            with_objective=False,
        )
        relerr(wu[0], wu[1])

        t0 = time.perf_counter()
        w, h, state = W, H, state0
        iters = 0
        r = relerr(w, h)
        # `not (r <= target)` keeps iterating on NaN (a diverged solver must
        # be reported as never reaching the target, not as instant success)
        while not (r <= target) and iters < max_iters:
            w, h, state, t, _conv, _ = _solve_while_from(
                upd, state, X, w, h, 0, jnp.asarray(chunk, jnp.int32), tol,
                with_objective=False,
            )
            iters += int(t)
            r = relerr(w, h)
            if trajectory:
                print(f"    iter {iters:5d}  relerr {r:.5f}", flush=True)
        elapsed = time.perf_counter() - t0
    return elapsed, iters, r


def _lowrank_noisy(rng, p, n, k, noise=0.01):
    """Rank-k nonnegative signal + uniform noise: a problem where a fixed
    relative reconstruction error at rank k is achievable and meaningful."""
    Wg = rng.random((p, k), dtype=np.float32)
    Hg = rng.random((k, n), dtype=np.float32)
    return Wg @ Hg + noise * rng.random((p, n), dtype=np.float32)


# Targets: roughly the quality reached after ~100 reference-default
# iterations, well above each problem's noise floor so every solver can
# cross them.
TTT = {
    "ttt1": {"target": 0.010, "desc": "500x500 k8 MU-MSE"},
    "ttt2": {"target": 0.020, "desc": "2000x1000 k32 MU-KL"},
    "ttt3": {"target": 0.0125, "desc": "100kx10k k64 projals/alspgrad"},
    # ratings-like sparse X is nowhere near rank-128 (the zeros dominate);
    # its CD relerr floor is ~0.83, so the quality gate sits just above it
    "ttt4": {"target": 0.84, "desc": "sparse powerlaw k128 cd/greedycd"},
}


def ttt1(trajectory=False):
    import jax.numpy as jnp

    from nmf_tpu.models.multupd import MultUpdate

    rng = np.random.default_rng(0)
    X = jnp.asarray(_lowrank_noisy(rng, 500, 500, 8))
    W = jnp.asarray(rng.random((500, 8), dtype=np.float32))
    H = jnp.asarray(rng.random((8, 500), dtype=np.float32))
    target = TTT["ttt1"]["target"]
    upd, _ = MultUpdate(obj="mse")._resolved(np.float32)
    sec, iters, r = _time_to_tol(upd, X, W, H, target, chunk=200, trajectory=trajectory)
    return {
        "metric": "ttt1_mu_mse_500x500_k8",
        "value": round(sec, 4),
        "unit": f"sec_to_relerr_{target}",
        "iters": iters,
        "relerr": round(r, 5),
    }


def ttt2(trajectory=False):
    import jax.numpy as jnp

    from nmf_tpu.models.multupd import MultUpdate

    rng = np.random.default_rng(0)
    X = jnp.asarray(_lowrank_noisy(rng, 2000, 1000, 32))
    W = jnp.asarray(rng.random((2000, 32), dtype=np.float32))
    H = jnp.asarray(rng.random((32, 1000), dtype=np.float32))
    target = TTT["ttt2"]["target"]
    upd, _ = MultUpdate(obj="div")._resolved(np.float32)
    sec, iters, r = _time_to_tol(upd, X, W, H, target, chunk=100, trajectory=trajectory)
    return {
        "metric": "ttt2_mu_kl_2000x1000_k32",
        "value": round(sec, 4),
        "unit": f"sec_to_relerr_{target}",
        "iters": iters,
        "relerr": round(r, 5),
    }


def ttt3(trajectory=False):
    import jax.numpy as jnp

    from nmf_tpu.models.alspgrad import ALSPGrad
    from nmf_tpu.models.projals import ProjectedALS

    rng = np.random.default_rng(0)
    p, n, k = 100_000, 10_000, 64
    X = jnp.asarray(_lowrank_noisy(rng, p, n, k))
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))
    target = TTT["ttt3"]["target"]
    pa, _ = ProjectedALS(maxiter=100)._resolved(np.float32)
    sec_pa, it_pa, r_pa = _time_to_tol(
        pa, X, W, H, target, chunk=5, max_iters=300, trajectory=trajectory
    )
    al, _ = ALSPGrad(maxiter=100, maxsubiter=20)._resolved(np.float32)
    sec_al, it_al, r_al = _time_to_tol(
        al, X, W, H, target, chunk=2, max_iters=100, trajectory=trajectory
    )
    return {
        "metric": "ttt3_100kx10k_k64",
        "value": round(sec_pa, 3),
        "unit": f"projals_sec_to_relerr_{target}",
        "projals": {"sec": round(sec_pa, 3), "iters": it_pa, "relerr": round(r_pa, 5)},
        "alspgrad": {"sec": round(sec_al, 3), "iters": it_al, "relerr": round(r_al, 5)},
    }


def _movielens_like(rng, p=163_000, n=59_000, nnz=25_000_000):
    rows = np.minimum((rng.pareto(1.2, nnz) * p / 50), p - 1).astype(np.int64)
    cols = np.minimum((rng.pareto(1.2, nnz) * n / 50), n - 1).astype(np.int64)
    rows = rng.permutation(p)[rows]
    cols = rng.permutation(n)[cols]
    key = np.unique(rows * n + cols)
    rows, cols = (key // n).astype(np.int32), (key % n).astype(np.int32)
    vals = (rng.random(len(key)) * 4 + 1).astype(np.float32)
    return rows, cols, vals


def ttt4(trajectory=False):
    # The HALS row is the headline: stable across builds/perturbations.
    # GreedyCD's iterations-to-0.84 is chaotic near its flat relerr floor
    # (1e-6-scale input perturbations swing it by tens of iterations): the
    # basin its trajectory lands in sets the crossing time.
    import jax.numpy as jnp

    from nmf_tpu.models.coorddesc import CoordinateDescent
    from nmf_tpu.models.greedycd import GreedyCD
    from nmf_tpu.ops.sparse_format import build_tiled

    rng = np.random.default_rng(0)
    p, n, k = 163_000, 59_000, 128
    rows, cols, vals = _movielens_like(rng)
    X = build_tiled(rows, cols, vals, (p, n))
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))
    target = TTT["ttt4"]["target"]
    cd, _ = CoordinateDescent(maxiter=100)._resolved(np.float32)
    sec_cd, it_cd, r_cd = _time_to_tol(
        cd, X, W, H, target, chunk=5, max_iters=200, trajectory=trajectory
    )
    g, _ = GreedyCD(maxiter=100)._resolved(np.float32)
    sec_g, it_g, r_g = _time_to_tol(
        g, X, W, H, target, chunk=5, max_iters=200, trajectory=trajectory
    )
    return {
        "metric": "ttt4_sparse_163kx59k_k128",
        "value": round(sec_cd, 3),
        "unit": f"hals_sec_to_relerr_{target}",
        "nnz": len(vals),
        "cd": {"sec": round(sec_cd, 3), "iters": it_cd, "relerr": round(r_cd, 5)},
        "greedycd": {"sec": round(sec_g, 3), "iters": it_g, "relerr": round(r_g, 5)},
    }


def config1():
    import jax.numpy as jnp

    from nmf_tpu.models.multupd import MultUpdate

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.random((500, 500), dtype=np.float32))
    W = jnp.asarray(rng.random((500, 8), dtype=np.float32))
    H = jnp.asarray(rng.random((8, 500), dtype=np.float32))
    rate = _solver_rate(MultUpdate(obj="mse"), X, W, H, 100, 2100)
    return {
        "metric": "c1_mu_mse_500x500_k8",
        "value": round(rate, 1),
        "unit": "iterations/sec",
    }


def config2():
    import jax
    import jax.numpy as jnp

    import nmf_tpu
    from nmf_tpu.models.multupd import MultUpdate

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.random((2000, 1000), dtype=np.float32))

    t0 = time.perf_counter()
    W, H = nmf_tpu.nndsvd(X, 32, variant="ar", key=jax.random.PRNGKey(0))
    jax.block_until_ready((W, H))
    _ = float(W.sum())  # readback sync
    init_cold = time.perf_counter() - t0  # includes QR/SVD compile
    t0 = time.perf_counter()
    W, H = nmf_tpu.nndsvd(X, 32, variant="ar", key=jax.random.PRNGKey(1))
    _ = float(W.sum())
    init_warm = time.perf_counter() - t0

    rate = _solver_rate(MultUpdate(obj="div"), X, W, H, 50, 550)
    return {
        "metric": "c2_mu_kl_2000x1000_k32_nndsvdar",
        "value": round(rate, 1),
        "unit": "iterations/sec",
        "nndsvdar_init_sec": round(init_warm, 3),
        "nndsvdar_init_cold_sec": round(init_cold, 3),
    }


def config3():
    import jax.numpy as jnp

    from nmf_tpu.models.alspgrad import ALSPGrad
    from nmf_tpu.models.projals import ProjectedALS

    rng = np.random.default_rng(0)
    p, n, k = 100_000, 10_000, 64
    # low-rank + noise so the solvers do real work
    X = jnp.asarray(
        (rng.random((p, k)).astype(np.float32) @ rng.random((k, n)).astype(np.float32))
        + 0.01 * rng.random((p, n)).astype(np.float32)
    )
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))

    import jax.numpy as jnp2
    from nmf_tpu.models.common import _solve_while

    def compile_sec(upd):
        t0 = time.perf_counter()
        out = _solve_while(
            upd, X, W, H, jnp2.asarray(2, jnp2.int32), jnp2.asarray(1e-30, X.dtype)
        )
        float(out[4])
        return time.perf_counter() - t0

    pa, _ = ProjectedALS(maxiter=100)._resolved(np.float32)
    comp_pa = compile_sec(pa)
    rate_pa = _solver_rate(pa, X, W, H, 3, 23)
    al, _ = ALSPGrad(maxiter=100, maxsubiter=20)._resolved(np.float32)
    comp_al = compile_sec(al)  # the flat-loop compile
    rate_al = _solver_rate(al, X, W, H, 2, 10)
    return {
        "metric": "c3_100kx10k_k64",
        "value": round(rate_pa, 2),
        "unit": "projals_iterations/sec",
        "alspgrad_iters_per_sec": round(rate_al, 3),
        "projals_compile_sec": round(comp_pa, 1),
        "alspgrad_compile_sec": round(comp_al, 1),
    }


def config4():
    import jax.numpy as jnp

    from nmf_tpu.models.coorddesc import CoordinateDescent
    from nmf_tpu.models.greedycd import GreedyCD
    from nmf_tpu.ops.sparse_format import build_tiled

    rng = np.random.default_rng(0)
    p, n, k = 163_000, 59_000, 128
    # MovieLens-style power-law marginals (real ratings matrices are heavily
    # skewed); dedup keeps ~21M nnz
    rows, cols, vals = _movielens_like(rng)
    nnz = len(vals)
    X = build_tiled(rows, cols, vals, (p, n))
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))

    cd, _ = CoordinateDescent(maxiter=100)._resolved(np.float32)
    rate_cd = _solver_rate(cd, X, W, H, 2, 8)
    g, _ = GreedyCD(maxiter=100)._resolved(np.float32)
    rate_g = _solver_rate(g, X, W, H, 2, 6)
    return {
        "metric": "c4_sparse_163kx59k_powerlaw_k128",
        "value": round(rate_cd, 3),
        "unit": "hals_iterations/sec",
        "greedycd_iters_per_sec": round(rate_g, 3),
        "nnz": nnz,
    }


def config5():
    """Weak scaling of the sharded MU sweep over this process's devices.

    Per-device problem size is fixed; the mesh grows 1 -> max devices (up
    to 8).  On the CPU's virtual devices this validates the sharded program
    (collective structure, per-device shapes), not a rate.
    """
    import jax
    import jax.numpy as jnp

    from nmf_tpu.models.common import _solve_while
    from nmf_tpu.models.multupd import MultUpdate
    from nmf_tpu.parallel.mesh import make_mesh
    from nmf_tpu.parallel.sharding import shard_problem

    ndev = len(jax.devices())
    base_p, base_n, k = 512, 512, 32
    rng = np.random.default_rng(0)
    results = {}
    meshes = [m for m in (1, 2, 4, 8) if m <= ndev]
    for d in meshes:
        shape = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}[d]
        p, n = base_p * shape[0], base_n * shape[1]
        X = jnp.asarray(rng.random((p, n), dtype=np.float32))
        W = jnp.asarray(rng.random((p, k), dtype=np.float32))
        H = jnp.asarray(rng.random((k, n), dtype=np.float32))
        mesh = make_mesh(shape, devices=jax.devices()[:d])
        X, W, H = shard_problem(mesh, X, W, H)
        rate = _solver_rate(MultUpdate(obj="mse"), X, W, H, 20, 120)
        results[d] = rate
    eff = (
        results[meshes[-1]] / results[meshes[0]] if len(meshes) > 1 else 1.0
    )
    return {
        "metric": "c5_weak_scaling_sim_mesh",
        "value": round(eff, 3),
        "unit": f"iters_rate_ratio_{meshes[-1]}dev_vs_1dev_fixed_per_dev_size",
        "rates": {str(d): round(r, 1) for d, r in results.items()},
        "note": "rates of one process over its own devices",
    }


def _capacity(metric, note, p, n, k, draws):
    """HALS and GreedyCD rates on one card at capacity scale, with
    device-side random init.  A failed solve fails the config."""
    from nmf_tpu.models.coorddesc import CoordinateDescent
    from nmf_tpu.ops.sparse_format import build_tiled

    rng = np.random.default_rng(0)
    rows, cols, vals = _movielens_like(rng, p=p, n=n, nnz=draws)
    t0 = time.perf_counter()
    X = build_tiled(rows, cols, vals, (p, n))
    build_sec = time.perf_counter() - t0
    cd, _ = CoordinateDescent(maxiter=100)._resolved(np.float32)
    rate_cd = _solver_rate_device_init(cd, X, p, n, k, 2, 6)
    mean_r, steady_r, times = _greedycd_chunked_rate(X, p, n, k)
    return {
        "metric": metric,
        "value": round(rate_cd, 3),
        "unit": "hals_iterations/sec",
        "nnz": len(vals),
        "host_build_sec": round(build_sec, 1),
        "greedycd_iters_per_sec": round(mean_r, 3),
        "greedycd_steady_iters_per_sec": round(steady_r, 3),
        "greedycd_iter_sec": [round(t, 2) for t in times],
        "note": note,
    }


def config6():
    """North-star capacity slice (the 10M x 1M rank-256 sparse target cut
    into (4, 4) blocks is ~625k x 250k per block; this config runs four
    blocks' worth on one card): 2M x 200k power-law sparse, ~80M nnz, rank
    256, HALS + GreedyCD."""
    return _capacity("c6_northstar_slice_2Mx200k_k256",
                     "per-chip slab of the 10M x 1M rank-256 north star",
                     2_000_000, 200_000, 256, 90_000_000)


def config7():
    """The exact per-block share of the 10M x 1M rank-256 north star under
    (4, 4) 2-D sharding, on one card: 2.5M x 250k, ~105M nnz (the same
    MovieLens-like density class as config6).  W alone is 2.56 GB and the
    solve carries ~3 copies."""
    return _capacity("c7_config5_per_chip_share_2.5Mx250k_k256",
                     "exact (4,4) per-chip share of the 10M x 1M rank-256 "
                     "north star",
                     2_500_000, 250_000, 256, 115_000_000)


def spa4():
    """SPA at config4 scale (163k x 59k power-law sparse, k=128): anchor
    selection (basis-tracking, sparse) + the batched-FNNLS H estimate whose
    column count (59k) is exactly the lockstep cliff the FNNLS compaction
    cascade targets (reference src/spa.jl:64)."""
    import jax.numpy as jnp

    from nmf_tpu.models.spa import spa
    from nmf_tpu.ops.sparse_format import build_tiled

    rng = np.random.default_rng(0)
    p, n, k = 163_000, 59_000, 128
    rows, cols, vals = _movielens_like(rng)
    X = build_tiled(rows, cols, vals, (p, n))
    from nmf_tpu import config as _cfg

    t_compile0 = time.perf_counter()
    W, H = spa(X, k)
    float(jnp.sum(H))
    compile_and_first = time.perf_counter() - t_compile0
    t0 = time.perf_counter()
    W, H = spa(X, k)
    float(jnp.sum(H))
    sec = time.perf_counter() - t0
    # solution quality proxy: relerr of the separable model fit
    from nmf_tpu.ops.objectives import mse_objective

    import jax

    rel = float(
        jnp.sqrt(2.0 * jax.jit(mse_objective)(X, W, H))
        / jnp.sqrt(jnp.sum(jnp.asarray(vals) ** 2))
    )
    return {
        "metric": "spa4_163kx59k_k128",
        "value": round(sec, 3),
        "unit": "sec_warm",
        "first_call_sec": round(compile_and_first, 3),
        "relerr": round(rel, 4),
        "nnz": len(vals),
        "fnnls_cascade": dict(_cfg.fnnls_cascade),
    }


CONFIGS = {
    "config1": config1,
    "config2": config2,
    "config3": config3,
    "config4": config4,
    "config5": config5,
    "config6": config6,
    "config7": config7,
    "spa4": spa4,
    "ttt1": ttt1,
    "ttt2": ttt2,
    "ttt3": ttt3,
    "ttt4": ttt4,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", default=["config1"])
    args = ap.parse_args()
    names = args.configs or ["config1"]
    if "all" in names:
        names = list(CONFIGS)
    unknown = [nm for nm in names if nm not in CONFIGS]
    if unknown:
        sys.exit(f"unknown config(s): {', '.join(unknown)}")
    device = require_gpu()
    from nmf_tpu import config as _config

    _config.enable_compilation_cache()
    failed = []
    for name in names:
        try:
            row = CONFIGS[name]()
        except Exception as e:  # keep the suite going; report the failure
            failed.append(name)
            row = {"metric": name, "error": repr(e)}
        print(json.dumps({**row, **device}), flush=True)
    if failed:
        sys.exit(f"config(s) failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
