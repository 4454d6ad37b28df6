"""Proof that nmf-tpu runs on one NVIDIA GPU through its normal entry points.

Run from the root of a checkout, on a machine with a GPU::

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: only the (2, 2) mesh path

One process drives the card(s).  Each phase prints one line with what it
checked, its seconds and its worst error against its tolerance.  The last
line of a passing run is one JSON object naming the device as JAX reports
it; any failed phase ends the run with a non-zero exit and no such line.
Without a GPU (JAX on the CPU, or no CUDA plugin) the script stops before
any phase.

Phases (one card):

1. device   platform ``gpu``, device kind, card name and power limit.
2. products ``X @ D``, ``X' @ D`` and the SDDMM on the config4 store
            (MovieLens-25M-shaped, 163k x 59k, ~17.6M nonzeros, k=128) and
            on its transpose, against float64 scipy:
            ``max|got - ref| / max|ref| <= 1e-5``.
3. dense    the default ``nnmf(X, 64)`` (GreedyCD + NNDSVDar through the
            randomized SVD) on a 100k x 10k low-rank-plus-noise matrix (4 GB
            float32): finite, and the relative error falls from 1 to 6
            iterations; one short solve of multmse, multdiv, projals,
            alspgrad, cd and spa through ``nnmf``, all finite; the default
            solve on a 2000 x 1000 matrix agrees with the CPU backend within
            1e-3 relative error.
4. sparse   ``nnmf`` on the config4 store, k=128, with cd (HALS), greedycd
            and multdiv for 5 iterations from one start: the objective
            agrees with the same solve on a BCOO copy of X (the
            ``jax.experimental.sparse`` product, an independent plain
            implementation) within 1e-3 relative.
5. gpu-lane the ``gpu``-marked tests, run by pytest inside this process.

``--four``: a (2, 2) mesh over four cards; sharded dense MU-MSE and
sharded sparse HALS and MU-div on the config4 matrix, each against the
same solve on one card within 1e-3 relative objective, with the warm
seconds of each sparse solve on the mesh and on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PRODUCT_TOL = 1e-5
SOLVE_TOL = 1e-3


def gpu_device():
    """The first JAX device, or SystemExit when it is not a GPU (JAX falls
    back to the CPU when the CUDA plugin fails to start)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); "
            "nothing was run"
        )
    return dev


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class Phases:
    """Runs phases, prints one line each, remembers failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            checks = fn()
        except Exception as e:  # a failed phase is reported, the rest run
            import traceback

            traceback.print_exc()
            self.failed.append(name)
            print(f"phase {name}: FAIL {type(e).__name__}: {e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            return
        bad = [c for c in checks if not c[1] <= c[2]]
        if bad:
            self.failed.append(name)
        worst = max(checks, key=_share) if checks else None
        detail = (f"worst {worst[0]} err {worst[1]:.3g} <= tol {worst[2]:.0e}"
                  if worst else "no comparisons")
        status = "ok" if not bad else "FAIL " + ", ".join(
            f"{c[0]} err {c[1]:.3g} > tol {c[2]:.0e}" for c in bad)
        print(f"phase {name}: {status}; {len(checks)} checks, {detail} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _share(check):
    """A check's error as a share of its tolerance."""
    _, err, tol = check
    if tol:
        return err / tol
    return 0.0 if err == 0 else float("inf")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _config4(seed=0):
    """The config4 matrix: (rows, cols, vals, (p, n)) and its store."""
    import jax

    from benchmarks.run import _movielens_like
    from nmf_tpu.io import loader
    from nmf_tpu.ops.sparse_format import build_tiled

    p, n = 163_000, 59_000
    t0 = time.perf_counter()
    rows, cols, vals = _movielens_like(np.random.default_rng(seed), p, n)
    t1 = time.perf_counter()
    native = loader.native_available()  # builds the library at first use
    t2 = time.perf_counter()
    X = jax.block_until_ready(build_tiled(rows, cols, vals, (p, n)))
    print(f"  config4 store: {len(vals)} nonzeros; generated in {t1 - t0:.1f} s, "
          f"native library {'ready' if native else 'MISSING'} in {t2 - t1:.1f} s, "
          f"store built in {time.perf_counter() - t2:.1f} s", flush=True)
    return rows, cols, vals, (p, n), X


def phase_products(c4):
    import jax.numpy as jnp
    import scipy.sparse

    from nmf_tpu.ops import matops

    rows, cols, vals, (p, n), X = c4
    k = 128
    rng = np.random.default_rng(1)
    D = rng.random((n, k), dtype=np.float32)
    E = rng.random((p, k), dtype=np.float32)
    W = rng.random((p, k), dtype=np.float32)
    H = rng.random((k, n), dtype=np.float32)
    A = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)),
                                shape=(p, n))
    ref_mm = A @ D.astype(np.float64)
    ref_mtm = (A.T @ E.astype(np.float64)).T
    ref_sd = np.einsum("ik,ik->i", W.astype(np.float64)[rows],
                       H.T.astype(np.float64)[cols])
    Dj, Ej, Wj, Hj = map(jnp.asarray, (D, E, W, H))
    checks = []
    Xt = X.transpose()
    checks += [
        ("mm", _rel(matops.mm(X, Dj), ref_mm), PRODUCT_TOL),
        ("mtm", _rel(matops.mtm(Ej.T, X), ref_mtm), PRODUCT_TOL),
        ("transposed mm", _rel(matops.mm(Xt, Ej), ref_mtm.T), PRODUCT_TOL),
        ("transposed mtm", _rel(matops.mtm(Dj.T, Xt), ref_mm.T), PRODUCT_TOL),
        ("sddmm", _rel(matops.sddmm(Wj, Hj, X), ref_sd), PRODUCT_TOL),
    ]
    return checks


def _lowrank(key, p, n, k):
    import jax

    ku, kv, ke = jax.random.split(key, 3)
    U = jax.random.uniform(ku, (p, k))
    V = jax.random.uniform(kv, (k, n))
    return U @ V + 0.01 * jax.random.uniform(ke, (p, n))


def _relerr(X, res):
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):
        R = X - res.W @ res.H
        return float(jnp.sqrt(jnp.sum(R * R) / jnp.sum(X * X)))


def phase_dense():
    import jax

    import nmf_tpu

    checks = []
    with jax.default_matmul_precision("highest"):
        X = _lowrank(jax.random.PRNGKey(0), 100_000, 10_000, 64)
    r2 = _relerr(X, nmf_tpu.nnmf(X, 64, maxiter=2, tol=1e-30))
    r6 = _relerr(X, nmf_tpu.nnmf(X, 64, maxiter=6, tol=1e-30))
    print(f"  default nnmf 100k x 10k k=64: relerr {r2:.5f} after 2, "
          f"{r6:.5f} after 6 iterations", flush=True)
    checks.append(("relerr falls", r6 / r2, 1.0 - 1e-6))
    for alg in ("multmse", "multdiv", "projals", "alspgrad", "cd", "spa"):
        res = nmf_tpu.nnmf(X, 64, alg=alg, init="spa" if alg == "spa" else "nndsvdar",
                           maxiter=3, tol=1e-30)
        finite = bool(np.isfinite(res.objvalue)
                      and np.isfinite(np.asarray(res.W)).all()
                      and np.isfinite(np.asarray(res.H)).all())
        print(f"  {alg}: objective {float(res.objvalue):.6g}", flush=True)
        checks.append((f"{alg} finite", 0.0 if finite else np.inf, 1.0))
    del X
    # the same default solve on the GPU and on the CPU backend; the CPU
    # programs bypass the persistent cache, which may hold CPU programs
    # compiled for another host's instruction set
    errs = {}
    for plat in ("gpu", "cpu"):
        jax.config.update("jax_enable_compilation_cache", plat != "cpu")
        with jax.default_device(jax.devices(plat)[0]):
            with jax.default_matmul_precision("highest"):
                Xs = _lowrank(jax.random.PRNGKey(1), 2000, 1000, 16)
            errs[plat] = _relerr(Xs, nmf_tpu.nnmf(Xs, 16, maxiter=10, tol=1e-30))
    jax.config.update("jax_enable_compilation_cache", True)
    print(f"  2000 x 1000 k=16 relerr: gpu {errs['gpu']:.7f}, "
          f"cpu {errs['cpu']:.7f}", flush=True)
    checks.append(("gpu vs cpu relerr", abs(errs["gpu"] / errs["cpu"] - 1),
                   SOLVE_TOL))
    return checks


def phase_sparse(c4):
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    import nmf_tpu

    rows, cols, vals, (p, n), X = c4
    k = 128
    rng = np.random.default_rng(2)
    W0 = rng.random((p, k), dtype=np.float32)
    H0 = rng.random((k, n), dtype=np.float32)
    Xb = jsparse.BCOO((X.values, jnp.stack([X.row_idx, X.col_idx], 1)),
                      shape=(p, n), indices_sorted=True, unique_indices=True)
    checks = []
    for alg in ("cd", "greedycd", "multdiv"):
        obj = []
        for Xv in (X, Xb):
            res = nmf_tpu.nnmf(Xv, k, alg=alg, init="custom", W0=W0, H0=H0,
                               maxiter=5, tol=1e-30)
            assert res.niters == 5
            obj.append(float(res.objvalue))
        print(f"  {alg}: objective {obj[0]:.8g} (store) vs {obj[1]:.8g} (BCOO)",
              flush=True)
        checks.append((f"{alg} objective", abs(obj[0] / obj[1] - 1), SOLVE_TOL))
    return checks


def phase_gpu_lane():
    import pytest

    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-m", "gpu", os.path.join(ROOT, "tests", "test_gpu_lane.py")])
    return [("pytest exit code", float(rc), 0.0)]


def phase_four(c4):
    """The (2, 2) mesh against one card."""
    import jax
    import jax.numpy as jnp

    import nmf_tpu
    from nmf_tpu.ops.sparse_shard import shard_tiled
    from nmf_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh((2, 2))
    checks = []
    rng = np.random.default_rng(3)

    # dense MU-MSE
    k = 64
    with jax.default_matmul_precision("highest"):
        X = _lowrank(jax.random.PRNGKey(4), 40_000, 8_000, k)
    p, n = X.shape
    W0 = rng.random((p, k), dtype=np.float32)
    H0 = rng.random((k, n), dtype=np.float32)
    one = nmf_tpu.nnmf(X, k, alg="multmse", init="custom", W0=W0, H0=H0,
                       maxiter=10, tol=1e-30)
    four = nmf_tpu.nnmf(X, k, alg="multmse", init="custom", W0=W0, H0=H0,
                        maxiter=10, tol=1e-30, mesh=mesh)
    print(f"  dense multmse objective: {float(four.objvalue):.8g} (2x2) vs "
          f"{float(one.objvalue):.8g} (one card)", flush=True)
    checks.append(("dense multmse objective",
                   abs(float(four.objvalue) / float(one.objvalue) - 1), SOLVE_TOL))
    del X

    # sparse HALS and MU-div on the config4 matrix
    rows, cols, vals, (p, n), X1 = c4
    k = 128
    t0 = time.perf_counter()
    Xs = shard_tiled(rows, cols, vals, (p, n), mesh)
    print(f"  sharded store built in {time.perf_counter() - t0:.1f} s; "
          f"nonzeros per block {Xs.block_nnz}", flush=True)
    W0 = rng.random((p, k), dtype=np.float32)
    H0 = rng.random((k, n), dtype=np.float32)

    def solve(X, alg, **kw):
        res = nmf_tpu.nnmf(X, k, alg=alg, init="custom", W0=W0, H0=H0,
                           maxiter=5, tol=1e-30, **kw)
        return float(res.objvalue)

    for alg in ("cd", "multdiv"):
        objs, secs = [], []
        for X, kw in ((Xs, dict(mesh=mesh)), (X1, {})):
            solve(X, alg, **kw)  # compile
            t0 = time.perf_counter()
            objs.append(solve(X, alg, **kw))
            secs.append(time.perf_counter() - t0)
        print(f"  sparse {alg} objective: {objs[0]:.8g} (2x2) vs "
              f"{objs[1]:.8g} (one card); 5 iterations warm: "
              f"{secs[0]:.3f} s (2x2) vs {secs[1]:.3f} s (one card)",
              flush=True)
        checks.append((f"sparse {alg} objective",
                       abs(objs[0] / objs[1] - 1), SOLVE_TOL))
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the (2, 2) mesh path over four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import nmf_tpu  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from a checkout of the repo ({e})")
    from nmf_tpu import config

    dev = gpu_device()
    config.enable_compilation_cache()
    phases = Phases()
    print(f"card: {card_line()}", flush=True)
    phases.run("device", lambda: [])
    print(f"  {dev.platform} {dev.device_kind}, {len(__import__('jax').devices())} "
          "device(s)", flush=True)
    c4 = _config4()
    if args.four:
        phases.run("four", lambda: phase_four(c4))
    else:
        phases.run("products", lambda: phase_products(c4))
        phases.run("dense", phase_dense)
        phases.run("sparse", lambda: phase_sparse(c4))
        del c4
        phases.run("gpu-lane", phase_gpu_lane)
    if phases.failed:
        raise SystemExit(f"chip_smoke: failed phases: {', '.join(phases.failed)}")
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
