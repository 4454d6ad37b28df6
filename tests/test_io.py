"""Native data loader: MatrixMarket parse + COO->CSR against scipy oracles."""

import numpy as np
import pytest

from nmf_tpu.io import loader


@pytest.fixture
def mtx_file(tmp_path):
    rng = np.random.default_rng(0)
    p, n, nnz = 50, 40, 300
    rows = rng.integers(0, p, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.random(nnz).astype(np.float32)
    path = tmp_path / "test.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("% a comment line\n")
        f.write(f"{p} {n} {nnz}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r+1} {c+1} {v:.8g}\n")
    import scipy.sparse

    dense = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(p, n)).toarray()
    return path, dense


def test_native_library_builds():
    assert loader.native_available(), (
        "native/build/libnmf_host.so could not be built (see the warning)"
    )


def test_load_mtx(mtx_file):
    path, dense = mtx_file
    coo = loader.load_mtx(str(path))
    assert (coo.rows, coo.cols) == dense.shape
    got = np.zeros(dense.shape, np.float64)
    np.add.at(got, (coo.row_idx, coo.col_idx), coo.values.astype(np.float64))
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-7)


def test_coo_to_csr_dedupes(mtx_file):
    path, dense = mtx_file
    coo = loader.load_mtx(str(path))
    csr = loader.coo_to_csr(coo)
    import scipy.sparse

    m = scipy.sparse.csr_matrix(
        (csr.data, csr.indices, csr.indptr), shape=(csr.rows, csr.cols)
    )
    np.testing.assert_allclose(m.toarray(), dense, rtol=1e-5, atol=1e-6)
    # strictly sorted, duplicate-free columns per row
    for r in range(csr.rows):
        cols = csr.indices[csr.indptr[r] : csr.indptr[r + 1]]
        assert (np.diff(cols) > 0).all()


def test_to_bcoo_and_solve(mtx_file):
    path, dense = mtx_file
    coo = loader.load_mtx(str(path))
    X = loader.to_bcoo(coo)
    import nmf_tpu

    ret = nmf_tpu.nnmf(X, 4, alg="cd", init="random", maxiter=10)
    assert np.isfinite(ret.objvalue)


def test_numpy_fallback(mtx_file, monkeypatch):
    path, dense = mtx_file
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setattr(loader, "_LIB_TRIED", True)
    coo = loader.load_mtx(str(path))
    csr = loader.coo_to_csr(coo)
    import scipy.sparse

    m = scipy.sparse.csr_matrix(
        (csr.data, csr.indices, csr.indptr), shape=(csr.rows, csr.cols)
    )
    np.testing.assert_allclose(m.toarray(), dense, rtol=1e-5, atol=1e-6)


def test_native_binner_helpers_match_numpy():
    """The native parallel store-build helpers (stable radix argsort, fused
    3-array gather) are exact replacements for the numpy statements they
    accelerate.  Sizes exceed the native-path
    threshold (1 << 16) so the C++ code actually runs when built; heavy key
    ties exercise radix stability."""
    if not loader.native_available():
        import pytest

        pytest.skip("libnmf_host.so not built")
    rng = np.random.default_rng(3)
    n = 200_000
    keys = rng.integers(0, 1500, n).astype(np.int64)
    order = loader.stable_argsort(keys)
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    # a wide-range key hits multiple radix passes
    wide = rng.integers(0, 1 << 40, n).astype(np.int64)
    np.testing.assert_array_equal(
        loader.stable_argsort(wide), np.argsort(wide, kind="stable")
    )
    r = rng.integers(0, 999, n).astype(np.int32)
    c = rng.integers(0, 777, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    ro, co, vo = loader.gather3(order, r, c, v)
    np.testing.assert_array_equal(ro, r[order])
    np.testing.assert_array_equal(co, c[order])
    np.testing.assert_array_equal(vo, v[order])
