"""Sparse NMF demo: factorize a sparse user-item matrix.

Shows both sparse backends: jax BCOO (portable) and the TiledCSR store,
whose products run a sorted segment-sum and, on a GPU, a Triton SDDMM.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import nmf_tpu
from nmf_tpu.ops import sparse_format


def main():
    rng = np.random.default_rng(0)
    p, n, k = 2000, 1500, 16
    dense = (rng.random((p, k)) @ rng.random((k, n))) * (rng.random((p, n)) < 0.05)
    r, c = np.nonzero(dense)

    # BCOO path
    X = jsparse.BCOO(
        (jnp.asarray(dense[r, c], jnp.float32), jnp.asarray(np.stack([r, c], 1))),
        shape=(p, n),
    )
    ret = nmf_tpu.nnmf(X, k, alg="cd", init="random", maxiter=50)
    print(f"BCOO     cd: niters={ret.niters} objv={ret.objvalue:.5e}")

    # TiledCSR path
    Xt = sparse_format.build_tiled(r, c, dense[r, c], (p, n))
    ret2 = nmf_tpu.nnmf(Xt, k, alg="cd", init="random", maxiter=50)
    print(f"TiledCSR cd: niters={ret2.niters} objv={ret2.objvalue:.5e}")

    ret3 = nmf_tpu.nnmf(X, k, alg="multdiv", init="random", maxiter=25)
    print(f"BCOO multdiv (SDDMM): objv={ret3.objvalue:.5e}")


if __name__ == "__main__":
    main()
