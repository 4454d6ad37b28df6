"""Small numeric utilities (functional analogues of the reference's utils layer).

The reference implements these as in-place scalar loops over CPU arrays
(/root/reference/src/utils.jl:15-61).  Here every op is a pure function on
jax arrays: under ``jit`` XLA fuses them into the surrounding matmuls, so
they cost (close to) nothing — there is no reason for hand-written loops.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "adddiag",
    "normalize1",
    "normalize1_cols",
    "projectnn",
    "posneg",
    "printf_mat",
    "safe_div",
]


def adddiag(A, a):
    """Return ``A + a*I`` (reference ``adddiag!``, src/utils.jl:15-24)."""
    m, n = A.shape
    if m != n:
        raise ValueError("A must be square.")
    return A + a * jnp.eye(m, dtype=A.dtype)


def normalize1(a):
    """Scale ``a`` so its entries sum to one (src/utils.jl:26)."""
    return a / jnp.sum(a)


def normalize1_cols(a):
    """Scale each column of ``a`` to sum to one (src/utils.jl:28-32)."""
    return a / jnp.sum(a, axis=0, keepdims=True)


def projectnn(A):
    """Project all entries onto the non-negative orthant (src/utils.jl:34-41)."""
    return jnp.maximum(A, jnp.zeros((), dtype=A.dtype))


def posneg(A):
    """Split ``A = Ap - An`` into positive/negative parts (src/utils.jl:43-61)."""
    zero = jnp.zeros((), dtype=A.dtype)
    Ap = jnp.where(A >= 0, A, zero)
    An = jnp.where(A >= 0, zero, -A)
    return Ap, An


def safe_div(num, den):
    """``num / den`` with 0 where ``den == 0`` (guards the 0/0 in the
    convergence diagnostic; the reference lets 0/0 produce NaN which it only
    ever prints, src/common.jl:105)."""
    zero = jnp.zeros((), dtype=jnp.result_type(num, den))
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1), zero)


def printf_mat(x):
    """Print a matrix with the reference's ``%8.4f`` format (src/utils.jl:6-13)."""
    import numpy as np

    x = np.asarray(x)
    for i in range(x.shape[0]):
        print(" ".join(f"{v:8.4f}" for v in x[i]) + " ")
