"""Distributed NMF demo: dense and sparse solves over a 2-D device mesh.

Run on any machine (simulates an 8-device mesh on CPU when fewer real
devices are present):

    python examples/distributed_nmf.py

On a real multi-host pod, bootstrap each process first
(``nmf_tpu.parallel.mesh.init_distributed``) and drop the CPU forcing —
everything else is identical; GSPMD inserts the collectives (k x k Gram
psum, factor all-gathers) from the shardings alone.
"""

import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax

    if not os.environ.get("NMF_TPU_EXAMPLE_REAL"):
        # default: simulate an 8-device mesh on CPU (must happen before
        # first device use).  Set NMF_TPU_EXAMPLE_REAL=1 to use the real
        # devices of this process instead.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    import nmf_tpu
    from nmf_tpu.ops import sparse_format
    from nmf_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()  # ("rows", "cols") over all devices
    print(f"mesh: {dict(mesh.shape)} on {jax.default_backend()}")

    rng = np.random.default_rng(0)
    p, n, k = 1024, 768, 16
    X = jnp.asarray(
        (rng.random((p, k)) @ rng.random((k, n))).astype(np.float32)
    )

    # dense: nnmf shards X P(rows, cols), W P(rows), H P(cols)
    ret = nmf_tpu.nnmf(X, k, alg="cd", init="nndsvdar", maxiter=50, mesh=mesh)
    print(f"dense   cd: niters={ret.niters} objv={ret.objvalue:.5e}")
    print(f"  W sharding: {ret.W.sharding}")

    # sparse: the same front door; TiledCSR is resharded as a 2-D
    # ShardedTiled (device (i,j) owns its row/col block's nonzeros)
    dense = np.asarray(X) * (rng.random((p, n)) < 0.05)
    r, c = np.nonzero(dense)
    Xt = sparse_format.build_tiled(r, c, dense[r, c], (p, n))
    ret2 = nmf_tpu.nnmf(Xt, k, alg="multdiv", init="random", maxiter=25, mesh=mesh)
    print(f"sparse  multdiv: niters={ret2.niters} objv={ret2.objvalue:.5e}")

    # the default init's randomized SVD also runs sharded (distributed
    # CholeskyQR3 — the p-row sketch panel is never gathered)
    W0, H0 = nmf_tpu.nndsvd(
        jax.device_put(
            X, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rows", "cols"))
        ),
        k,
        variant="ar",
        key=jax.random.PRNGKey(0),
    )
    print(f"sharded nndsvdar init: W {W0.shape}, H {H0.shape} ok")


if __name__ == "__main__":
    main()
