"""Randomized equivalence of the sharded sparse store with dense math.

Each case draws a random geometry (dimensions the mesh does and does not
divide, dimensions smaller than the mesh, near-empty and empty matrices,
skewed nnz) and a random mesh shape, then checks mm/mtm/sddmm/scale
agreement between the sharded products and plain dense math.  This is the
edge hunter for the block and padding logic that example-based tests tend
to miss (devices with zero nonzeros, blocks past the matrix edge).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmf_tpu.ops.sparse_shard import (
    shard_tiled,
    sharded_mm,
    sharded_mtm,
    sharded_nnz_values,
    sharded_scale_values,
    sharded_sddmm,
)
from nmf_tpu.parallel.mesh import make_mesh

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices"
)


@requires_multidevice
@pytest.mark.parametrize("seed", range(8))
def test_sharded_random_geometry_matches_dense(seed):
    rng = np.random.default_rng(100 + seed)
    # geometry: sometimes exact tile multiples, sometimes awkward remainders
    p = int(rng.choice([3, 256, 300, 511, 512, 700, 1024]))
    n = int(rng.choice([5, 256, 260, 384, 512, 640]))
    density = float(rng.choice([0.0, 0.001, 0.01, 0.05]))
    mesh_shape = [(2, 4), (4, 2), (1, 8), (8, 1)][int(rng.integers(4))]

    Xd = (rng.random((p, n)) * (rng.random((p, n)) < density)).astype(
        np.float32
    )
    if rng.random() < 0.5:  # a dense-ish head block
        h = min(p, n, 64)
        Xd[:h, :h] += ((rng.random((h, h)) < 0.7) * rng.random((h, h))
                       ).astype(np.float32)
    r, c = np.nonzero(Xd)
    if len(r) == 0:  # fully-empty matrix: still must build and multiply
        r = np.zeros(0, np.int32)
        c = np.zeros(0, np.int32)
    mesh = make_mesh(mesh_shape)
    X = shard_tiled(r, c, Xd[r, c], Xd.shape, mesh)
    k = int(rng.choice([1, 5, 8]))
    D = jnp.asarray(rng.random((n, k)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mm(X, D)), Xd @ np.asarray(D), rtol=3e-5,
        atol=1e-4,
    )
    D2 = jnp.asarray(rng.random((p, k)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sharded_mtm(X, D2)), Xd.T @ np.asarray(D2), rtol=3e-5,
        atol=1e-4,
    )
    if len(r):
        W = jnp.asarray(np.abs(rng.random((p, k))).astype(np.float32))
        H = jnp.asarray(np.abs(rng.random((k, n))).astype(np.float32))
        wh = np.asarray(sharded_sddmm(X, W, H))
        v = np.asarray(sharded_nnz_values(X))
        np.testing.assert_allclose(
            (v * wh).sum(), (Xd * np.asarray(W @ H)).sum(), rtol=2e-4,
        )
        Y = sharded_scale_values(X, 2.0 * sharded_nnz_values(X))
        np.testing.assert_allclose(
            np.asarray(sharded_mm(Y, D)), 2 * Xd @ np.asarray(D), rtol=3e-5,
            atol=2e-4,
        )
