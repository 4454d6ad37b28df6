"""SDDMM for the GPU, in Pallas through Triton.

``out[e] = W[rows[e]] . Ht[cols[e]]`` for every stored entry e: the values
of ``W @ H`` sampled at a sparse pattern, with ``Ht = H'``.  One program
takes ``block`` consecutive entries, gathers their W rows and H' rows (k
contiguous floats each) into registers, multiplies and reduces over k, and
stores ``block`` values; nothing else is written.  XLA's own form of the
same gather-gather-reduce writes both gathered (nnz, k) operands to device
memory before reducing them (measured 3.4x off the byte roofline at
config4 on an H100, docs/sparse_kernel_design.md).

The arithmetic is exact float32 (no tensor cores), so the kernel agrees
with :func:`sddmm_reference` to float32 summation order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["sddmm_reference", "sddmm_triton"]


def sddmm_reference(rows, cols, W, Ht):
    """Plain XLA form: gather, gather, multiply, reduce over k."""
    return jnp.sum(jnp.take(W, rows, axis=0) * jnp.take(Ht, cols, axis=0),
                   axis=1)


def _kernel(rows_ref, cols_ref, w_ref, ht_ref, o_ref):
    w = w_ref[rows_ref[...], :]  # (block, K) gather of W rows
    h = ht_ref[cols_ref[...], :]  # (block, K) gather of H' rows
    o_ref[...] = jnp.sum(w * h, axis=1)


@partial(jax.jit, static_argnames=("block", "num_warps", "interpret"))
def sddmm_triton(rows, cols, W, Ht, *, block=32, num_warps=4,
                 interpret=False):
    """(nnz,) float32 samples; ``interpret=True`` runs the kernel in the
    Pallas interpreter (CPU tests)."""
    nnz = rows.shape[0]
    k = W.shape[1]
    K = max(16, 1 << (k - 1).bit_length())  # Triton blocks are powers of two
    W = jnp.pad(W.astype(jnp.float32), ((0, 0), (0, K - k)))
    Ht = jnp.pad(Ht.astype(jnp.float32), ((0, 0), (0, K - k)))
    nb = -(-nnz // block)
    # padding entries sample (0, 0) and are cut off below
    rows = jnp.pad(rows, (0, nb * block - nnz))
    cols = jnp.pad(cols, (0, nb * block - nnz))
    blk = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    out = pl.pallas_call(
        _kernel,
        grid=(nb,),
        in_specs=[blk, blk, whole(W), whole(Ht)],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((nb * block,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        interpret=interpret,
        name="sddmm",
    )(rows, cols, W, Ht)
    return out[:nnz]
