"""TiledCSR (the CSR-order sparse store) and its plain-XLA products
(``nmf_tpu.ops.tiled``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse

import nmf_tpu
from nmf_tpu.ops import matops
from nmf_tpu.ops.sparse_format import build_tiled
from nmf_tpu.ops.tiled import tiled_mm, tiled_mtm, tiled_sddmm


def make(seed=0, p=300, n=260, density=0.05):
    rng = np.random.default_rng(seed)
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < density)).astype(np.float32)
    r, c = np.nonzero(Xd)
    return Xd, build_tiled(r, c, Xd[r, c], (p, n)), rng


def _powerlaw_coo(seed=11, p=700, n=520, nnz=24000, alpha=1.2):
    """Deduplicated power-law rows and columns (ratings-matrix shaped)."""
    rng = np.random.default_rng(seed)
    r = np.minimum((rng.pareto(alpha, nnz) * p / 50), p - 1).astype(np.int64)
    c = np.minimum((rng.pareto(alpha, nnz) * n / 50), n - 1).astype(np.int64)
    key = np.unique(r * n + c)
    r, c = (key // n).astype(np.int32), (key % n).astype(np.int32)
    v = rng.random(len(r)).astype(np.float32)
    Xd = np.zeros((p, n), np.float32)
    Xd[r, c] = v
    return Xd, r, c, v, rng


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("k", [1, 8, 9, 128])
def test_products_match_float64_scipy(k):
    """Products at widths that are and are not a multiple of 8, and at the
    config4 width, agree with float64 scipy to 1e-5 of the largest value."""
    Xd, r, c, v, rng = _powerlaw_coo(seed=k)
    X = build_tiled(r, c, v, Xd.shape)
    A = scipy.sparse.csr_matrix((v.astype(np.float64), (r, c)), shape=Xd.shape)
    D = rng.random((Xd.shape[1], k), dtype=np.float32)
    E = rng.random((Xd.shape[0], k), dtype=np.float32)
    assert _rel(tiled_mm(X, jnp.asarray(D)), A @ D.astype(np.float64)) < 1e-5
    assert _rel(tiled_mtm(X, jnp.asarray(E)), A.T @ E.astype(np.float64)) < 1e-5


def test_empty_rows_and_powerlaw():
    # all nnz in the first and last rows: the middle rows and many columns
    # are empty and must come out zero; power-law column skew
    rng = np.random.default_rng(3)
    p, n, nnz = 1200, 700, 4000
    rows = np.where(rng.random(nnz) < 0.5, rng.integers(0, 90, nnz), rng.integers(p - 40, p, nnz))
    cols = np.minimum((rng.pareto(1.1, nnz) * 3).astype(np.int64), n - 1)
    vals = rng.random(nnz).astype(np.float32)
    Xd = np.zeros((p, n), np.float32)
    np.add.at(Xd, (rows, cols), vals)
    r, c = np.nonzero(Xd)
    X = build_tiled(r, c, Xd[r, c], (p, n))
    D = jnp.asarray(rng.random((n, 9)).astype(np.float32))
    got = np.asarray(matops.mm(X, D))
    np.testing.assert_allclose(got, Xd @ np.asarray(D), rtol=2e-5, atol=1e-4)
    assert not got[90:p - 40].any()
    D2 = jnp.asarray(rng.random((p, 9)).astype(np.float32))
    got2 = np.asarray(matops.mtm(D2.T, X))
    np.testing.assert_allclose(got2, np.asarray(D2).T @ Xd, rtol=2e-5, atol=1e-4)


def test_format_roundtrip():
    """Every nonzero is stored once, entries are sorted by row, col_order
    sorts them by column, and with_values keeps the pattern."""
    Xd, X, rng = make()
    assert int(X.nnz) == (Xd != 0).sum()
    r, c = np.asarray(X.row_idx), np.asarray(X.col_idx)
    assert (np.diff(r.astype(np.int64) * Xd.shape[1] + c) > 0).all()
    co = np.asarray(X.col_order)
    assert (np.diff(c[co].astype(np.int64) * Xd.shape[0] + r[co]) > 0).all()
    np.testing.assert_array_equal(np.asarray(X.values), Xd[r, c])
    X2 = X.with_values(X.values * 2)
    np.testing.assert_allclose(np.asarray(X2.values), np.asarray(X.values) * 2)
    assert X2.row_idx is X.row_idx and X2.col_order is X.col_order


def test_build_sorts_unsorted_input():
    """Shuffled COO input builds the same store as sorted input."""
    Xd, X, rng = make(seed=4)
    r, c = np.nonzero(Xd)
    perm = rng.permutation(len(r))
    Y = build_tiled(r[perm], c[perm], Xd[r, c][perm], Xd.shape)
    for a in ("row_idx", "col_idx", "values", "col_order"):
        np.testing.assert_array_equal(np.asarray(getattr(Y, a)),
                                      np.asarray(getattr(X, a)))


def test_mm_mtm_match_dense():
    Xd, X, rng = make()
    D = jnp.asarray(rng.random((Xd.shape[1], 8)).astype(np.float32))
    got = np.asarray(matops.mm(X, D))
    np.testing.assert_allclose(got, Xd @ np.asarray(D), rtol=2e-5, atol=1e-5)
    D2 = jnp.asarray(rng.random((Xd.shape[0], 8)).astype(np.float32))
    got2 = np.asarray(matops.mtm(D2.T, X))
    np.testing.assert_allclose(got2, np.asarray(D2).T @ Xd, rtol=2e-5, atol=1e-5)


def test_reductions_and_sddmm():
    Xd, X, rng = make()
    np.testing.assert_allclose(np.asarray(matops.colsums(X)), Xd.sum(0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(matops.rowsums(X)), Xd.sum(1), rtol=1e-5)
    assert np.isclose(float(matops.sq_norm(X)), (Xd**2).sum(), rtol=1e-5)
    W = jnp.asarray(rng.random((Xd.shape[0], 6)).astype(np.float32))
    H = jnp.asarray(rng.random((6, Xd.shape[1])).astype(np.float32))
    vals = np.asarray(matops.sddmm(W, H, X))
    WH = np.asarray(W) @ np.asarray(H)
    r, c = np.asarray(X.row_idx), np.asarray(X.col_idx)
    np.testing.assert_allclose(vals, WH[r, c], rtol=2e-5, atol=1e-6)


def test_transpose():
    """The transposed store runs both products through the swapped orders,
    and transposing twice gives the store back."""
    Xd, X, rng = make()
    Xt = matops.transpose(X)
    assert Xt.col_order is None and Xt.row_order is X.col_order
    D = jnp.asarray(rng.random((Xd.shape[0], 5)).astype(np.float32))
    got = np.asarray(matops.mm(Xt, D))
    np.testing.assert_allclose(got, Xd.T @ np.asarray(D), rtol=2e-5, atol=1e-5)
    E = jnp.asarray(rng.random((Xd.shape[1], 5)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(tiled_mtm(Xt, E)), Xd @ np.asarray(E),
                               rtol=2e-5, atol=1e-5)
    Xtt = Xt.transpose()
    assert Xtt.shape == X.shape and Xtt.row_order is None


@pytest.mark.parametrize("view", ["stored", "transposed"])
def test_sddmm_matches_dense(view):
    """The SDDMM == dense sampling at the pattern, on the stored and on the
    transposed orientation (reference src/multupd.jl:170-192 samples WH at
    X's pattern)."""
    rng = np.random.default_rng(3)
    p, n, k = 400, 300, 9
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.04)).astype(np.float32)
    r, c = np.nonzero(Xd)
    X = build_tiled(r, c, Xd[r, c], Xd.shape)
    if view == "transposed":
        X, Xd, p, n = X.transpose(), Xd.T, n, p
    W = jnp.asarray(rng.random((p, k)).astype(np.float32))
    H = jnp.asarray(rng.random((k, n)).astype(np.float32))
    WH = np.asarray(W) @ np.asarray(H)
    got = np.asarray(tiled_sddmm(X, W, H))
    ref = WH[np.asarray(X.row_idx), np.asarray(X.col_idx)]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_solver_with_tiled_matches_bcoo():
    from jax.experimental import sparse as jsparse

    Xd, X, rng = make(p=140, n=120, density=0.1)
    Xs = jsparse.BCOO.fromdense(jnp.asarray(Xd))
    k = 4
    W0 = jnp.asarray(rng.random((Xd.shape[0], k)).astype(np.float32))
    H0 = jnp.asarray(rng.random((k, Xd.shape[1])).astype(np.float32))
    alg = nmf_tpu.MultUpdate(obj="mse", maxiter=5)
    a = nmf_tpu.solve(alg, Xs, W0, H0)
    b = nmf_tpu.solve(alg, X, W0, H0)
    assert b.niters == a.niters
    np.testing.assert_allclose(np.asarray(b.W), np.asarray(a.W), rtol=1e-4, atol=1e-6)
    assert np.isclose(b.objvalue, a.objvalue, rtol=1e-4)


def test_with_values_matches_rebuild():
    """Products of a value-refreshed store == products of a store rebuilt
    from the new values; stats follow the new values."""
    Xd, X, rng = make()
    new = matops.nnz_values(X) * 2.5 + 0.1
    a = X.with_values(new)
    b = build_tiled(np.asarray(X.row_idx), np.asarray(X.col_idx),
                    np.asarray(new), X.shape)
    D = jnp.asarray(rng.random((Xd.shape[1], 7)).astype(np.float32))
    E = jnp.asarray(rng.random((Xd.shape[0], 7)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(tiled_mm(a, D)),
                               np.asarray(tiled_mm(b, D)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tiled_mtm(a, E)),
                               np.asarray(tiled_mtm(b, E)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.stats), np.asarray(b.stats),
                               rtol=1e-5)


def test_stats_serve_the_value_reductions():
    """sq_norm / total_sum / all_nonneg read the stored stats, which
    with_values keeps current (a negative value flips all_nonneg)."""
    Xd, X, rng = make()
    np.testing.assert_allclose(float(matops.sq_norm(X)), (Xd**2).sum(), rtol=1e-5)
    np.testing.assert_allclose(float(matops.total_sum(X)), Xd.sum(), rtol=1e-5)
    assert bool(matops.all_nonneg(X))
    assert X.dtype == jnp.float32
    Y = X.with_values(X.values.at[0].set(-1.0))
    assert not bool(matops.all_nonneg(Y))


@pytest.mark.parametrize(
    "alg", ["multmse", "multdiv", "cd", "greedycd", "projals", "alspgrad"])
def test_solvers_match_bcoo(alg):
    """Every solver on a power-law TiledCSR matches the BCOO reference path
    (mm/mtm/sddmm and the value refresh all flow through the store)."""
    from jax.experimental import sparse as jsparse

    Xd, r, c, v, rng = _powerlaw_coo(seed=29, p=300, n=260, nnz=6000)
    X = build_tiled(r, c, v, Xd.shape)
    Xs = jsparse.BCOO.fromdense(jnp.asarray(Xd))
    k = 4
    W0 = jnp.asarray(rng.random((Xd.shape[0], k)).astype(np.float32))
    H0 = jnp.asarray(rng.random((k, Xd.shape[1])).astype(np.float32))
    algs = {
        "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=5),
        "multdiv": nmf_tpu.MultUpdate(obj="div", maxiter=5),
        "cd": nmf_tpu.CoordinateDescent(maxiter=5),
        "greedycd": nmf_tpu.GreedyCD(maxiter=5),
        "projals": nmf_tpu.ProjectedALS(maxiter=5),
        "alspgrad": nmf_tpu.ALSPGrad(maxiter=3, maxsubiter=5),
    }
    a = nmf_tpu.solve(algs[alg], Xs, W0, H0)
    b = nmf_tpu.solve(algs[alg], X, W0, H0)
    assert b.niters == a.niters
    np.testing.assert_allclose(np.asarray(b.W), np.asarray(a.W), rtol=2e-4, atol=1e-4)
    assert np.isclose(b.objvalue, a.objvalue, rtol=1e-4)


def test_spa_on_tiled_matches_dense():
    """SPA (column normalization through col_indices/scale_values, anchors,
    FNNLS) on the store matches the dense path."""
    from nmf_tpu.models.spa import spa

    Xd, X, rng = make(p=300, n=260, density=0.07)
    Ws, Hs = spa(X, 4)
    Wd, Hd = spa(jnp.asarray(Xd), 4)
    np.testing.assert_allclose(np.asarray(Ws), np.asarray(Wd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hd), rtol=2e-3, atol=2e-3)


def test_empty_store():
    """A matrix with no nonzeros builds, multiplies to zero and keeps
    finite stats."""
    X = build_tiled(np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32), (50, 40))
    assert int(X.nnz) == 0
    out = tiled_mm(X, jnp.ones((40, 3), jnp.float32))
    assert out.shape == (50, 3) and not np.asarray(out).any()
    assert tiled_mtm(X, jnp.ones((50, 3), jnp.float32)).shape == (40, 3)
    assert np.isfinite(np.asarray(X.stats)).all()


@pytest.mark.parametrize("shape", [(1, 300), (300, 1)])
def test_single_row_or_column(shape):
    rng = np.random.default_rng(6)
    Xd = (rng.random(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
    r, c = np.nonzero(Xd)
    X = build_tiled(r, c, Xd[r, c], shape)
    D = jnp.asarray(rng.random((shape[1], 5)).astype(np.float32))
    E = jnp.asarray(rng.random((shape[0], 5)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(tiled_mm(X, D)), Xd @ np.asarray(D),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tiled_mtm(X, E)), Xd.T @ np.asarray(E),
                               rtol=2e-5, atol=1e-6)


def test_product_gradient_is_the_transpose_product():
    """d/dD sum(G * (X @ D)) = X' G: the segment-sum product differentiates
    into the transposed product."""
    Xd, X, rng = make(seed=8)
    D = jnp.asarray(rng.random((Xd.shape[1], 4)).astype(np.float32))
    G = jnp.asarray(rng.random((Xd.shape[0], 4)).astype(np.float32))
    g = jax.grad(lambda D: jnp.sum(G * tiled_mm(X, D)))(D)
    np.testing.assert_allclose(np.asarray(g), Xd.T @ np.asarray(G),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize(
    "geom",
    [dict(), dict(p=520, n=700), dict(alpha=0.8), dict(alpha=2.5),
     dict(nnz=200)],
    ids=["powerlaw", "wide", "heavy-head", "light-head", "near-empty"],
)
def test_powerlaw_products_match_dense(geom):
    """Power-law rows and columns of varied skew: every product, the SDDMM
    and a value refresh match the dense reference."""
    Xd, r, c, v, rng = _powerlaw_coo(**geom)
    p, n = Xd.shape
    k = 9
    X = build_tiled(r, c, v, (p, n))
    D = jnp.asarray(rng.random((n, k)).astype(np.float32))
    E = jnp.asarray(rng.random((p, k)).astype(np.float32))
    W = jnp.asarray(rng.random((p, k)).astype(np.float32))
    H = jnp.asarray(rng.random((k, n)).astype(np.float32))
    scale = np.abs(Xd).sum()
    np.testing.assert_allclose(
        np.asarray(tiled_mm(X, D)), Xd @ np.asarray(D),
        rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(
        np.asarray(tiled_mtm(X, E)), Xd.T @ np.asarray(E),
        rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(
        np.asarray(tiled_sddmm(X, W, H)),
        (np.asarray(W) @ np.asarray(H))[r, c], rtol=1e-5, atol=1e-5)
    X2 = X.with_values(jnp.asarray(v * 3))
    np.testing.assert_allclose(
        np.asarray(tiled_mm(X2, D)), 3 * (Xd @ np.asarray(D)),
        rtol=1e-5, atol=3e-6 * scale)


def test_kl_solve_on_tiled_matches_dense():
    """MU-div (sddmm + scale_values each iteration) on the store matches the
    dense solve."""
    Xd, r, c, v, rng = _powerlaw_coo(seed=13)
    k = 5
    X = build_tiled(r, c, v, Xd.shape)
    W0 = jnp.asarray(rng.random((Xd.shape[0], k)).astype(np.float32))
    H0 = jnp.asarray(rng.random((k, Xd.shape[1])).astype(np.float32))
    alg = nmf_tpu.MultUpdate(obj="div", maxiter=4, tol=1e-30)
    a = nmf_tpu.solve(alg, X, W0, H0)
    b = nmf_tpu.solve(alg, jnp.asarray(Xd), W0, H0)
    np.testing.assert_allclose(
        np.asarray(a.W), np.asarray(b.W), rtol=2e-3, atol=2e-4)
    assert np.isclose(a.objvalue, b.objvalue, rtol=1e-3)
