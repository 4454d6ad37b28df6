"""Mirrors /root/reference/test/interf.jl: the full alg x init grid, external
initdata, replicates, custom init round-trip, update_H=False contract, and
verbose printing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import nmf_tpu as M

ALGS = ("multmse", "multdiv", "projals", "alspgrad", "cd", "greedycd")
INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "spa")


def make_problem(dtype, seed=101):
    rng = np.random.default_rng(seed)
    p, n, k = 5, 8, 3
    while True:
        Wg = np.maximum(rng.random((p, k)) - 0.3, 0).astype(dtype)
        Hg = np.maximum(rng.random((k, n)) - 0.3, 0).astype(dtype)
        X = (Wg @ Hg).astype(dtype)
        # keep the fixture generic: no all-zero columns/rows (the reference
        # draws until its global RNG happens to give a benign X)
        if (X.sum(axis=0) > 0).all() and (X.sum(axis=1) > 0).all():
            return X, Wg, Hg


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("alg", ALGS)
def test_grid(dtype, alg):
    X, _, _ = make_problem(dtype)
    k = 3
    for init in INITS:
        ret = M.nnmf(jnp.asarray(X), k, alg=alg, init=init, seed=7)
        assert ret.W.shape == (5, k)
        assert ret.H.shape == (k, 8)
        assert np.isfinite(ret.objvalue)


@pytest.mark.parametrize("alg", ALGS)
def test_external_initdata(alg):
    X, _, _ = make_problem(np.float64)
    U, s, Vt = np.linalg.svd(X, full_matrices=False)
    ret = M.nnmf(jnp.asarray(X), 3, alg=alg, init="nndsvd", initdata=(U, s, Vt.T))
    assert np.isfinite(ret.objvalue)


def test_replicates_then_custom():
    X, _, _ = make_problem(np.float64)
    rep = M.nnmf(jnp.asarray(X), 3, replicates=10, maxiter=10, alg="multmse")
    ret = M.nnmf(jnp.asarray(X), 3, W0=rep.W, H0=rep.H, init="custom")
    assert np.isfinite(ret.objvalue)


def test_replicates_keeps_best():
    X, _, _ = make_problem(np.float64)
    one = M.nnmf(jnp.asarray(X), 3, replicates=1, maxiter=10, alg="multmse", seed=3)
    many = M.nnmf(jnp.asarray(X), 3, replicates=8, maxiter=10, alg="multmse", seed=3)
    assert many.objvalue <= one.objvalue + 1e-12


def test_parallel_replicates():
    """Vmapped restarts draw the same init keys as the sequential loop
    (``split(key, replicates-1)``), so the best-of Result must agree."""
    X, _, _ = make_problem(np.float64)
    seq = M.nnmf(jnp.asarray(X), 3, replicates=6, maxiter=10, alg="multmse", seed=3)
    par = M.nnmf(
        jnp.asarray(X), 3, replicates=6, maxiter=10, alg="multmse", seed=3,
        parallel_replicates=True,
    )
    assert par.niters == seq.niters
    assert par.converged == seq.converged
    np.testing.assert_allclose(par.objvalue, seq.objvalue, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(par.W), np.asarray(seq.W), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(par.H), np.asarray(seq.H), rtol=1e-10, atol=1e-12
    )


def test_spa_alg():
    X, _, _ = make_problem(np.float64)
    ret = M.nnmf(jnp.asarray(X), 3, alg="spa", init="spa")
    assert ret.niters == 0 and ret.converged
    with pytest.raises(ValueError):
        M.nnmf(jnp.asarray(X), 3, alg="spa", init="random")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("alg", ALGS)
def test_update_H_false(dtype, alg):
    rng = np.random.default_rng(103)
    X, _, _ = make_problem(dtype)
    W = np.maximum(rng.random((5, 3)) - 0.3, 0).astype(dtype)
    H = np.maximum(rng.random((3, 8)) - 0.3, 0).astype(dtype) + 0.01
    ret = M.nnmf(
        jnp.asarray(X), 3, alg=alg, init="custom",
        W0=W.copy(), H0=H.copy(), update_H=False,
    )
    assert np.array_equal(np.asarray(ret.H), H)
    assert not np.array_equal(np.asarray(ret.W), W)


def test_verbose_printing(capsys):
    X, _, _ = make_problem(np.float64)
    M.nnmf(jnp.asarray(X), 3, alg="cd", init="nndsvd", verbose=True)
    out = capsys.readouterr().out
    assert "objv" in out


def test_validation_errors():
    X, _, _ = make_problem(np.float64)
    Xj = jnp.asarray(X)
    with pytest.raises(ValueError):
        M.nnmf(-Xj, 3)
    with pytest.raises(ValueError):
        M.nnmf(Xj, 6)  # k > min(p, n)
    with pytest.raises(ValueError):
        M.nnmf(Xj, 3, replicates=0)
    with pytest.raises(ValueError):
        M.nnmf(Xj, 3, init="custom")  # missing W0/H0
    with pytest.raises(ValueError):
        M.nnmf(Xj, 3, init="custom", W0=jnp.zeros((5, 2)), H0=jnp.zeros((3, 8)))
    with pytest.raises(ValueError):
        M.nnmf(Xj, 3, init="bogus")
    with pytest.raises(ValueError):
        M.nnmf(Xj, 3, alg="bogus")
    with pytest.warns(UserWarning):
        M.nnmf(Xj, 3, W0=jnp.zeros((5, 3)), maxiter=5, alg="multmse")
    with pytest.warns(UserWarning):
        M.nnmf(Xj, 3, update_H=False, maxiter=5, alg="multmse")


def test_config_precision_and_verbose_chunk(monkeypatch, capsys):
    """Precision resolution (every solver "highest" unless overridden, the
    global override wins everywhere) and the chunked verbose table
    (row-for-row identical output to chunk=1)."""
    from nmf_tpu import config

    for alg in (M.GreedyCD(), M.ALSPGrad(), M.MultUpdate(obj="div"),
                M.MultUpdate(obj="mse")):
        assert config.solver_precision(alg) == "highest"
    config.set_matmul_precision("tensorfloat32")
    try:
        assert config.solver_precision(M.GreedyCD()) == "tensorfloat32"
        res = M.nnmf(jnp.asarray(make_problem(np.float32)[0]), 3, maxiter=5, seed=0)
        assert res.niters <= 5
    finally:
        config.set_matmul_precision(None)
    assert config.effective_verbose_chunk() == 1
    with pytest.raises(ValueError):
        config.set_matmul_precision("bf16ish")

    # Chunked verbose output must match single-step output row for row
    # (values exact; only the elapsed column differs).
    X, _, _ = make_problem(np.float64)
    Xj = jnp.asarray(X)

    def table(chunk):
        config.set_verbose_chunk(chunk)
        try:
            M.nnmf(Xj, 3, alg="projals", init="random", seed=2, maxiter=9, verbose=True)
        finally:
            config.set_verbose_chunk(None)
        rows = capsys.readouterr().out.strip().splitlines()
        # drop the elapsed-time column (index 1)
        return [
            tuple(c for i, c in enumerate(r.split()) if i != 1) for r in rows
        ]

    assert table(4) == table(1)
    with pytest.raises(ValueError):
        config.set_verbose_chunk(0)
