"""GPU lane: the sparse products compiled for the card, one solve per solver
family, and the sharded code on a (1, 1) mesh, with NaN guards.

Every test here is marked ``gpu`` and skips unless JAX's first device is a
GPU; the CPU suite only ever runs these code paths through XLA's CPU
backend.  ``python chip_smoke.py`` runs this lane on the card, inside its
own process (``pytest -m gpu --noconftest tests/test_gpu_lane.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nmf_tpu
from nmf_tpu.ops import matops
from nmf_tpu.ops.sparse_format import build_tiled

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (python chip_smoke.py runs this lane)")


@pytest.fixture(scope="module")
def tiled_problem():
    rng = np.random.default_rng(0)
    p, n = 2000, 1500
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.02)).astype(np.float32)
    r, c = np.nonzero(Xd)
    X = build_tiled(r, c, Xd[r, c], Xd.shape)
    return Xd, X, rng


@pytest.mark.parametrize("view", ["stored", "transposed"])
def test_tiled_mm_matches_dense_on_gpu(tiled_problem, view):
    Xd, X, rng = tiled_problem
    if view == "transposed":
        X, Xd = X.transpose(), Xd.T
    D = jnp.asarray(rng.random((Xd.shape[1], 64)).astype(np.float32))
    got = np.asarray(matops.mm(X, D))
    np.testing.assert_allclose(got, Xd @ np.asarray(D), rtol=3e-5, atol=1e-3)
    D2 = jnp.asarray(rng.random((Xd.shape[0], 64)).astype(np.float32))
    got2 = np.asarray(matops.mtm(D2.T, X).T)
    np.testing.assert_allclose(got2, Xd.T @ np.asarray(D2), rtol=3e-5, atol=1e-3)


def test_tiled_sddmm_matches_dense_on_gpu(tiled_problem):
    Xd, X, rng = tiled_problem
    W = jnp.asarray(rng.random((Xd.shape[0], 16)).astype(np.float32))
    H = jnp.asarray(rng.random((16, Xd.shape[1])).astype(np.float32))
    got = np.asarray(matops.sddmm(W, H, X))
    ref = (np.asarray(W) @ np.asarray(H))[np.asarray(X.row_idx), np.asarray(X.col_idx)]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4)


def test_tiled_multdiv_solve_on_gpu(tiled_problem):
    """multdiv on tiled X runs the SDDMM and the value refresh inside the
    jitted solve loop under the solver's precision scope."""
    Xd, X, rng = tiled_problem
    res = nmf_tpu.solve(
        nmf_tpu.MultUpdate(obj="div", maxiter=5),
        X,
        jnp.asarray(rng.random((Xd.shape[0], 8)).astype(np.float32)),
        jnp.asarray(rng.random((8, Xd.shape[1])).astype(np.float32)),
    )
    assert res.niters == 5 and np.isfinite(res.objvalue)
    assert not np.isnan(np.asarray(res.W)).any()


@pytest.mark.parametrize("algname", ["multmse", "projals", "cd", "greedycd", "alspgrad"])
def test_dense_solvers_finite_on_gpu(algname):
    """Each solver survives its matmul precision on a low-rank + noise
    problem (a reduced-precision Gram can go indefinite and turn projals'
    Cholesky into NaN)."""
    rng = np.random.default_rng(1)
    p, n, k = 4096, 2048, 64
    Xd = rng.random((p, k), dtype=np.float32) @ rng.random((k, n), dtype=np.float32)
    Xd += 0.01 * rng.random((p, n), dtype=np.float32)
    X = jnp.asarray(Xd)
    W = jnp.asarray(rng.random((p, k), dtype=np.float32))
    H = jnp.asarray(rng.random((k, n), dtype=np.float32))
    algs = {
        "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=5),
        "projals": nmf_tpu.ProjectedALS(maxiter=5),
        "cd": nmf_tpu.CoordinateDescent(maxiter=5),
        "greedycd": nmf_tpu.GreedyCD(maxiter=3),
        "alspgrad": nmf_tpu.ALSPGrad(maxiter=2, maxsubiter=5),
    }
    res = nmf_tpu.solve(algs[algname], X, W, H)
    assert np.isfinite(res.objvalue)
    assert not np.isnan(np.asarray(res.W)).any()
    assert not np.isnan(np.asarray(res.H)).any()


def test_sharded_single_card_mesh():
    """The sharded dense path compiles and runs on a (1, 1) mesh."""
    from nmf_tpu.parallel.mesh import make_mesh
    from nmf_tpu.parallel.sharding import shard_problem

    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.random((512, 512), dtype=np.float32))
    W = jnp.asarray(rng.random((512, 8), dtype=np.float32))
    H = jnp.asarray(rng.random((8, 512), dtype=np.float32))
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    X, W, H = shard_problem(mesh, X, W, H)
    res = nmf_tpu.solve(nmf_tpu.MultUpdate(obj="mse", maxiter=5), X, W, H)
    assert res.niters == 5 and np.isfinite(res.objvalue)


def test_sharded_sparse_single_card_mesh():
    """The sharded sparse store runs its per-device products and the
    Triton SDDMM inside shard_map on a (1, 1) mesh and matches the dense
    products; one divergence sweep runs the per-nonzero ops."""
    from nmf_tpu.ops.sparse_shard import (
        shard_tiled,
        sharded_mm,
        sharded_mtm,
        sharded_sddmm,
    )
    from nmf_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    p, n = 2000, 1500
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.005)).astype(np.float32)
    Xd[:130, :130] += (
        (rng.random((130, 130)) < 0.9) * rng.random((130, 130))
    ).astype(np.float32)
    r, c = np.nonzero(Xd)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    D = jnp.asarray(rng.random((n, 64)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mm(X, D)), Xd @ np.asarray(D), rtol=3e-5, atol=1e-3
    )
    D2 = jnp.asarray(rng.random((p, 64)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mtm(X, D2)), Xd.T @ np.asarray(D2), rtol=3e-5,
        atol=1e-3,
    )
    W = jnp.asarray(rng.random((p, 16)).astype(np.float32))
    H = jnp.asarray(rng.random((16, n)).astype(np.float32))
    wh = np.asarray(sharded_sddmm(X, W, H))[0, 0, : len(r)]
    np.testing.assert_allclose(wh, (np.asarray(W) @ np.asarray(H))[r, c],
                               rtol=2e-5, atol=1e-4)
    res = nmf_tpu.solve(
        nmf_tpu.MultUpdate(obj="div", maxiter=3),
        X,
        jnp.asarray(np.abs(rng.random((p, 8))).astype(np.float32)),
        jnp.asarray(np.abs(rng.random((8, n))).astype(np.float32)),
    )
    assert res.niters == 3 and np.isfinite(res.objvalue)
