"""Dtype-parametric numeric constants.

The reference library is generic over the element type ``T`` and derives all of
its tolerances from ``eps(T)`` (e.g. per-solver ``tol = cbrt(eps(T))``,
``nnmf`` top-level ``tol = cbrt(eps(T)/100)``; see /root/reference/src/interf.jl:8
and /root/reference/src/multupd.jl:21).  We mirror that: every default is a
function of the working dtype, so float32 (the device-native type) and float64
(the parity-test type, with ``jax_enable_x64``) both behave like the reference
does for the same ``T``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "eps",
    "cbrt_eps",
    "default_tol",
    "sqrt_eps",
    "quartic_root_eps",
    "canonical_dtype",
]


def canonical_dtype(dtype) -> np.dtype:
    """Canonicalize a dtype-like object to a numpy floating dtype."""
    d = np.dtype(dtype)
    if d.kind != "f":
        raise TypeError(f"Expected a floating dtype, got {d}")
    return d


def eps(dtype) -> float:
    """Machine epsilon for ``dtype`` (Julia ``eps(T)``)."""
    return float(jnp.finfo(canonical_dtype(dtype)).eps)


def sqrt_eps(dtype) -> float:
    """``sqrt(eps(T))`` — the MU denominator guard (src/multupd.jl:48-50)."""
    return float(np.sqrt(eps(dtype)))


def cbrt_eps(dtype) -> float:
    """``cbrt(eps(T))`` — the per-solver default tolerance
    (src/multupd.jl:21, src/projals.jl:28, src/alspgrad.jl:362)."""
    return float(np.cbrt(eps(dtype)))


def quartic_root_eps(dtype) -> float:
    """``eps(T)^(1/4)`` — ALSPGrad's default inner gradient tolerance
    (src/alspgrad.jl:363)."""
    return float(eps(dtype) ** 0.25)


def default_tol(dtype) -> float:
    """``cbrt(eps(T)/100)`` — the ``nnmf`` front-door default tolerance
    (src/interf.jl:8): ~1.305e-6 for float64, ~1.06e-3 for float32."""
    return float(np.cbrt(eps(dtype) / 100.0))
