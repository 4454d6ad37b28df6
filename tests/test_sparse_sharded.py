"""2-D sharded sparse X (ShardedTiled) on the simulated 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import nmf_tpu
from nmf_tpu.ops import matops
from jax.sharding import NamedSharding, PartitionSpec as P

from nmf_tpu.ops.sparse_shard import (
    shard_tiled,
    sharded_load_stats,
    sharded_mm,
    sharded_mtm,
)
from nmf_tpu.parallel.mesh import COLS, make_mesh
from nmf_tpu.parallel.sharding import w_sharding, h_sharding

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices"
)


def make(seed=0, p=600, n=500, density=0.05):
    rng = np.random.default_rng(seed)
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < density)).astype(np.float32)
    r, c = np.nonzero(Xd)
    return Xd, r, c, rng


@requires_multidevice
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8)], ids=str)
def test_sharded_products_match_dense(mesh_shape):
    Xd, r, c, rng = make()
    mesh = make_mesh(mesh_shape)
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    D = jnp.asarray(rng.random((Xd.shape[1], 12)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mm(X, D)), Xd @ np.asarray(D), rtol=3e-5, atol=1e-4
    )
    D2 = jnp.asarray(rng.random((Xd.shape[0], 12)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mtm(X, D2)), Xd.T @ np.asarray(D2), rtol=3e-5, atol=1e-4
    )
    # matops dispatch + logical transpose
    np.testing.assert_allclose(
        np.asarray(matops.mm(matops.transpose(X), D2)),
        Xd.T @ np.asarray(D2),
        rtol=3e-5,
        atol=1e-4,
    )
    assert bool(matops.all_nonneg(X))
    assert np.isclose(float(matops.sq_norm(X)), (Xd**2).sum(), rtol=1e-5)


@requires_multidevice
def test_output_shardings_are_canonical():
    Xd, r, c, rng = make(p=256, n=256)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    D = jnp.asarray(rng.random((256, 8)).astype(np.float32))
    out = sharded_mm(X, D)
    # X @ D is the XH' shape -> must land in the canonical W sharding
    assert out.sharding.is_equivalent_to(w_sharding(mesh), out.ndim)
    # X' @ D is the (W'X)' shape -> the canonical H' layout
    out_t = sharded_mtm(X, D)
    assert out_t.sharding.is_equivalent_to(
        NamedSharding(mesh, P(COLS, None)), out_t.ndim)


@requires_multidevice
@pytest.mark.parametrize(
    "alg", ["multmse", "multdiv", "cd", "greedycd", "projals", "alspgrad"]
)
def test_sharded_sparse_solvers_match_dense(alg):
    Xd, r, c, rng = make(p=256, n=192, density=0.08)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    k = 4
    W0 = np.abs(rng.random((Xd.shape[0], k))).astype(np.float32)
    H0 = np.abs(rng.random((k, Xd.shape[1]))).astype(np.float32)

    algs = {
        "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=5),
        "multdiv": nmf_tpu.MultUpdate(obj="div", maxiter=5),
        "cd": nmf_tpu.CoordinateDescent(maxiter=5),
        "greedycd": nmf_tpu.GreedyCD(maxiter=4),
        "projals": nmf_tpu.ProjectedALS(maxiter=5),
        "alspgrad": nmf_tpu.ALSPGrad(maxiter=3, maxsubiter=5),
    }
    dense = nmf_tpu.solve(algs[alg], jnp.asarray(Xd), jnp.asarray(W0), jnp.asarray(H0))
    Wd = jax.device_put(jnp.asarray(W0), w_sharding(mesh))
    Hd = jax.device_put(jnp.asarray(H0), h_sharding(mesh))
    sp = nmf_tpu.solve(algs[alg], X, Wd, Hd)
    assert sp.niters == dense.niters
    np.testing.assert_allclose(np.asarray(sp.W), np.asarray(dense.W), rtol=5e-4, atol=1e-4)
    assert np.isclose(sp.objvalue, dense.objvalue, rtol=1e-4)


@requires_multidevice
def test_sharded_sparse_kl_matches_dense():
    """kl_objective and the per-nnz ops it rides (sddmm, nnz_values) on
    ShardedTiled match the dense gkldiv (reference src/multupd.jl:148)."""
    from nmf_tpu.ops.objectives import gkldiv, kl_objective

    Xd, r, c, rng = make(p=256, n=192)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    W = jnp.asarray(np.abs(rng.random((256, 4))).astype(np.float32))
    H = jnp.asarray(np.abs(rng.random((4, 192))).astype(np.float32))
    sharded = float(kl_objective(X, W, H))
    dense = float(gkldiv(jnp.asarray(Xd).astype(W.dtype), W @ H))
    assert np.isclose(sharded, dense, rtol=1e-4)


@requires_multidevice
def test_sharded_scale_values_updates_products():
    """scale_values on ShardedTiled feeds both products: mm() and mtm() on
    the scaled matrix match dense."""
    Xd, r, c, rng = make(p=256, n=192)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    v = matops.nnz_values(X)
    Y = matops.scale_values(X, 2.0 * v + v * v)
    Yd = 2.0 * Xd + Xd * Xd
    D = jnp.asarray(rng.random((192, 6)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(matops.mm(Y, D)), Yd @ np.asarray(D), rtol=3e-5, atol=1e-4
    )
    D2 = jnp.asarray(rng.random((256, 6)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(matops.mtm(D2.T, Y).T), Yd.T @ np.asarray(D2), rtol=3e-5, atol=1e-4
    )


@requires_multidevice
@pytest.mark.parametrize("alg", ["multmse", "multdiv", "cd", "greedycd"])
def test_sharded_skewed_solvers_match_dense(alg):
    """Solvers on a matrix whose nonzeros crowd into one block (a dense
    head over a very sparse tail): the blocks' entry counts differ by far
    more than the padding, and most devices run mostly padding."""
    rng = np.random.default_rng(7)
    p, n, k = 300, 260, 3
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.01)).astype(np.float32)
    Xd[:40, :40] += ((rng.random((40, 40)) < 0.8) * rng.random((40, 40))).astype(
        np.float32
    )
    r, c = np.nonzero(Xd)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    assert sharded_load_stats(X)["imbalance_max_over_mean"] > 3
    algs = {
        "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=5),
        "multdiv": nmf_tpu.MultUpdate(obj="div", maxiter=5),
        "cd": nmf_tpu.CoordinateDescent(maxiter=5),
        "greedycd": nmf_tpu.GreedyCD(maxiter=4),
    }
    W0 = np.abs(rng.random((p, k))).astype(np.float32)
    H0 = np.abs(rng.random((k, n))).astype(np.float32)
    dense = nmf_tpu.solve(algs[alg], jnp.asarray(Xd), jnp.asarray(W0), jnp.asarray(H0))
    Wd = jax.device_put(jnp.asarray(W0), w_sharding(mesh))
    Hd = jax.device_put(jnp.asarray(H0), h_sharding(mesh))
    sp = nmf_tpu.solve(algs[alg], X, Wd, Hd)
    assert sp.niters == dense.niters
    np.testing.assert_allclose(
        np.asarray(sp.W), np.asarray(dense.W), rtol=5e-4, atol=1e-4
    )
    assert np.isclose(sp.objvalue, dense.objvalue, rtol=1e-4)


@requires_multidevice
def test_front_door_rebuilds_tiled_on_mesh():
    """shard_problem turns a TiledCSR into a ShardedTiled holding every
    nonzero once, whose products match the one-device store's."""
    from nmf_tpu.ops.sparse_format import build_tiled
    from nmf_tpu.parallel.sharding import shard_problem

    Xd, r, c, rng = make(seed=8, p=300, n=260, density=0.03)
    Xt = build_tiled(r, c, Xd[r, c], Xd.shape)
    mesh = make_mesh((2, 4))
    W = jnp.zeros((300, 2), jnp.float32)
    H = jnp.zeros((2, 260), jnp.float32)
    Xs, _, _ = shard_problem(mesh, Xt, W, H)
    assert matops.is_sharded_tiled(Xs)
    assert sum(map(sum, Xs.block_nnz)) == len(r)
    D = jnp.asarray(rng.random((260, 5)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(matops.mm(Xs, D)),
                               np.asarray(matops.mm(Xt, D)), rtol=2e-5,
                               atol=1e-5)


@requires_multidevice
def test_sharded_spa_matches_dense():
    """SPA (anchors + FNNLS H) on ShardedTiled matches the dense path
    (reference src/spa.jl:41-68 is matrix-generic)."""
    from nmf_tpu.models.spa import spa

    Xd, r, c, rng = make(p=300, n=260, density=0.07)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    Ws, Hs = spa(X, 4)
    Wd, Hd = spa(jnp.asarray(Xd), 4)
    np.testing.assert_allclose(np.asarray(Ws), np.asarray(Wd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hd), rtol=2e-3, atol=2e-3)


@requires_multidevice
@pytest.mark.parametrize("alg", ["multdiv", "cd", "greedycd"])
def test_nnmf_front_door_sparse_mesh(alg):
    """The reference's one-entry-point contract on sharded sparse X
    (src/interf.jl:3-13): nnmf(TiledCSR, mesh=...) and nnmf(ShardedTiled,
    mesh=...) run init -> solve -> Result end-to-end and agree with the
    dense nnmf on the same problem and seed."""
    from nmf_tpu.ops.sparse_format import build_tiled

    Xd, r, c, rng = make(seed=3, p=300, n=260, density=0.06)
    k = 3
    dense = nmf_tpu.nnmf(
        jnp.asarray(Xd), k, alg=alg, init="random", maxiter=8, seed=11
    )

    mesh = make_mesh((2, 4))
    Xt = build_tiled(r, c, Xd[r, c], Xd.shape)
    via_tiled = nmf_tpu.nnmf(
        Xt, k, alg=alg, init="random", maxiter=8, seed=11, mesh=mesh
    )
    assert via_tiled.niters == dense.niters
    # GreedyCD's per-row argmax schedule is chaotic under f32
    # order-of-summation differences (the sharded products accumulate in
    # another order: per block, then psum), so its factors drift at ~1e-2
    # scale while the objective stays put
    tol = dict(rtol=5e-2, atol=5e-2) if alg == "greedycd" else dict(
        rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(via_tiled.W), np.asarray(dense.W), **tol
    )
    np.testing.assert_allclose(
        np.asarray(via_tiled.H), np.asarray(dense.H), **tol
    )
    assert np.isclose(via_tiled.objvalue, dense.objvalue, rtol=1e-3)

    # prebuilt ShardedTiled passes straight through
    Xs = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    via_sharded = nmf_tpu.nnmf(
        Xs, k, alg=alg, init="random", maxiter=8, seed=11, mesh=mesh
    )
    assert np.isclose(via_sharded.objvalue, dense.objvalue, rtol=1e-4)


@requires_multidevice
def test_nnmf_front_door_sparse_default_init():
    """nnmf on sharded sparse X with the DEFAULT init (nndsvdar -> rsvd ->
    distributed CholeskyQR3) — the full reference-default path on the mesh."""
    rng = np.random.default_rng(9)
    p, n, k = 300, 260, 3
    Wg = np.abs(rng.random((p, k))).astype(np.float32)
    Hg = (np.abs(rng.random((k, n))) * (rng.random((k, n)) < 0.3)).astype(np.float32)
    Xd = Wg @ Hg
    r, c = np.nonzero(Xd)
    mesh = make_mesh((2, 4))
    Xs = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    res = nmf_tpu.nnmf(Xs, k, alg="cd", maxiter=30, seed=0, mesh=mesh)
    assert np.isfinite(res.objvalue)
    rel = np.linalg.norm(
        Xd - np.asarray(res.W) @ np.asarray(res.H)
    ) / np.linalg.norm(Xd)
    assert rel < 0.15, rel


@requires_multidevice
def test_sharded_load_stats():
    """Per-block nnz accounting sums to the true nnz, every device runs the
    largest block's count, and the skew ratio is reported."""
    rng = np.random.default_rng(12)
    p, n = 600, 500
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.01)).astype(np.float32)
    Xd[:40, :40] += np.abs(rng.random((40, 40))).astype(np.float32)
    r, c = np.nonzero(Xd)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    st = sharded_load_stats(X)
    assert st["total_nnz"].shape == (2, 4)
    assert int(st["total_nnz"].sum()) == len(r)
    assert int(st["total_nnz"][0, 0]) == ((Xd[:300, :125]) != 0).sum()
    assert st["imbalance_max_over_mean"] >= 1.0
    assert st["padded_entries_per_device"] == int(st["total_nnz"].max())


@requires_multidevice
@pytest.mark.parametrize(
    "alg", ["multmse", "multdiv", "cd"], ids=str,
)
def test_sharded_uneven_blocks_solvers_match_dense(alg):
    """Dimensions that the mesh does not divide (the last block row and
    column are short): solver results must match dense."""
    rng = np.random.default_rng(9)
    p, n, k = 301, 263, 3
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.04)).astype(np.float32)
    Xd[p - 1, n - 1] = 0.5  # a nonzero in the last row and column
    r, c = np.nonzero(Xd)
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    algs = {
        "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=5),
        "multdiv": nmf_tpu.MultUpdate(obj="div", maxiter=5),
        "cd": nmf_tpu.CoordinateDescent(maxiter=5),
    }
    W0 = np.abs(rng.random((p, k))).astype(np.float32)
    H0 = np.abs(rng.random((k, n))).astype(np.float32)
    dense = nmf_tpu.solve(algs[alg], jnp.asarray(Xd), jnp.asarray(W0), jnp.asarray(H0))
    # the factors' canonical shardings need divisible dimensions: here
    # they stay where jnp puts them and the products reshard them
    sp = nmf_tpu.solve(algs[alg], X, jnp.asarray(W0), jnp.asarray(H0))
    assert sp.niters == dense.niters
    np.testing.assert_allclose(
        np.asarray(sp.W), np.asarray(dense.W), rtol=5e-4, atol=1e-4
    )
    assert np.isclose(sp.objvalue, dense.objvalue, rtol=1e-4)


@requires_multidevice
def test_sharded_per_nnz_ops():
    """sddmm / nnz_values / col_ids / scale_values in the entry layout, on
    the stored and on the transposed orientation."""
    from nmf_tpu.ops.sparse_shard import (
        sharded_col_ids,
        sharded_nnz_values,
        sharded_scale_values,
        sharded_sddmm,
    )

    Xd, r, c, rng = make(seed=10, p=301, n=263, density=0.04)
    p, n, k = 301, 263, 4
    mesh = make_mesh((2, 4))
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    W = jnp.asarray(np.abs(rng.random((p, k))).astype(np.float32))
    H = jnp.asarray(np.abs(rng.random((k, n))).astype(np.float32))
    v = np.asarray(sharded_nnz_values(X))
    assert (v != 0).sum() == len(r)
    # sddmm == (W@H) at the pattern, weighted by the values
    wh = np.asarray(sharded_sddmm(X, W, H))
    want = (((np.asarray(W) @ np.asarray(H)) * (Xd != 0)) * Xd).sum()
    assert np.isclose((wh * v).sum(), want, rtol=1e-4)
    # column sums through the global column ids
    ids = np.asarray(sharded_col_ids(X))
    assert ids.min() >= 0 and ids.max() < n
    np.testing.assert_allclose(np.bincount(ids.ravel(), v.ravel(), n),
                               Xd.sum(0), rtol=1e-5, atol=1e-6)
    Xt = X.transpose()
    ids_t = np.asarray(sharded_col_ids(Xt))
    np.testing.assert_allclose(np.bincount(ids_t.ravel(), v.ravel(), p),
                               Xd.sum(1), rtol=1e-5, atol=1e-6)
    wh_t = np.asarray(sharded_sddmm(Xt, H.T, W.T))
    np.testing.assert_allclose(wh_t, wh, rtol=1e-5, atol=1e-6)
    # doubling the values through scale_values doubles the sum
    X2 = sharded_scale_values(X, jnp.asarray(v) * 2)
    assert np.isclose(float(matops.total_sum(X2)), 2 * Xd.sum(), rtol=1e-5)
    assert np.isclose(float(matops.sq_norm(X2)), 4 * (Xd**2).sum(), rtol=1e-5)
