"""Small dense linear algebra on the replicated k x k Grams.

The reference reaches LAPACK ``potrf!/potrs!/potri!`` through Julia
(/root/reference/src/utils.jl:63-84) for the Cholesky solves in ProjectedALS.
Here the Grams are k x k (k <= a few hundred), replicated across the mesh, so
we use XLA's Cholesky (``jax.scipy.linalg``) directly — no sharding, no custom
kernel needed; the cost is negligible next to the p x n work.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl

__all__ = ["pdsolve", "pdrsolve"]


def pdsolve(A, x):
    """Return ``inv(A) @ x`` for symmetric positive definite ``A``
    (reference ``pdsolve!``, src/utils.jl:63-70)."""
    c, lower = jsl.cho_factor(A)
    return jsl.cho_solve((c, lower), x)


def pdrsolve(A, B, out_dtype=None):
    """Return ``A @ inv(B)`` for symmetric positive definite ``B``
    (reference ``pdrsolve!``, src/utils.jl:72-84).

    Uses ``(inv(B) @ A.T).T`` — B is symmetric so this equals ``A @ inv(B)``.
    """
    c, lower = jsl.cho_factor(B)
    return jsl.cho_solve((c, lower), A.T).T
