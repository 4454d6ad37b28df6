"""Global configuration knobs.

``matmul_precision``: global override for the matmul precision used inside
solver loops.  ``None`` (default) means every solver runs its matmuls at
``"highest"`` (exact float32), which matches the reference's convergence and
is the ``nnmf`` contract: on a GPU the backend default for float32 matmuls
may be TF32 (about three decimal digits), which caps how far an iterative
solver converges.  Set one of jax's precision names to force another mode
everywhere, e.g. ``nmf_tpu.config.set_matmul_precision("tensorfloat32")``
to trade the convergence floor for tensor-core speed.
"""

from __future__ import annotations

import contextlib
import os

import jax

__all__ = [
    "matmul_precision",
    "set_matmul_precision",
    "solver_precision",
    "precision_scope",
    "verbose_chunk",
    "set_verbose_chunk",
    "effective_verbose_chunk",
    "enable_compilation_cache",
    "greedycd_cascade",
    "set_greedycd_cascade",
    "fnnls_cascade",
    "set_fnnls_cascade",
    "dispatch_chunk",
    "set_dispatch_chunk",
    "dispatch_chunk_scope",
]

matmul_precision: str | None = None

#: Iterations batched per device round-trip in ``verbose=True`` solves
#: (None = 1: exact per-iteration wall clock in the table, like the
#: reference).
verbose_chunk: int | None = None


def _env_int(name: str, default: int, lo: int) -> int:
    """Integer environment knob; a non-integer value falls back to
    ``default`` and values below ``lo`` clamp to ``lo``."""
    try:
        val = int(os.environ.get(name, default))
    except ValueError:
        return default
    # clamp: shrink < 2 makes the cascade-size loop spin forever at trace
    # time; min/off_rows < 1 grow the caps list unboundedly
    return max(val, lo)


def set_verbose_chunk(value: int | None):
    global verbose_chunk
    if value is not None and (not isinstance(value, int) or value < 1):
        raise ValueError("verbose_chunk must be a positive int or None")
    verbose_chunk = value


def effective_verbose_chunk() -> int:
    return verbose_chunk or 1


#: Max solver iterations per device dispatch for non-verbose solves.
#: None = unchunked: the whole solve is ONE while_loop dispatch (lowest
#: overhead; the default).  A chunk sets the checkpoint and host re-entry
#: granularity of long solves while producing bit-identical results: the
#: chunked driver resumes the SAME jitted while_loop body from the carried
#: solver state (``_solve_while_from``), so the update/stop sequence is
#: unchanged.  Also settable via NMF_TPU_DISPATCH_CHUNK (read at import; a
#: value that is not a positive integer means unchunked).
dispatch_chunk: int | None = _env_int("NMF_TPU_DISPATCH_CHUNK", 0, 0) or None


def set_dispatch_chunk(value: int | None):
    """Set the global iterations-per-dispatch cap (None = unchunked)."""
    global dispatch_chunk
    if value is not None and (not isinstance(value, int) or value < 1):
        raise ValueError("dispatch_chunk must be a positive int or None")
    dispatch_chunk = value


class dispatch_chunk_scope:
    """Scoped override of :data:`dispatch_chunk` (used by
    ``nnmf(dispatch_chunk=...)``)."""

    def __init__(self, value: int | None):
        if value is not None and (not isinstance(value, int) or value < 1):
            raise ValueError("dispatch_chunk must be a positive int or None")
        self.value = value

    def __enter__(self):
        global dispatch_chunk
        self.saved = dispatch_chunk
        dispatch_chunk = self.value
        return self

    def __exit__(self, *exc):
        global dispatch_chunk
        dispatch_chunk = self.saved
        return False

def set_matmul_precision(value: str | None):
    """Force a global matmul precision for all solver loops (None = the
    default, "highest")."""
    global matmul_precision
    allowed = (
        None,
        "default",
        "bfloat16",
        "high",
        "tensorfloat32",
        "float32",
        "highest",
    )
    if value not in allowed:
        raise ValueError(f"matmul_precision must be one of {allowed}")
    matmul_precision = value


def solver_precision(alg) -> str:
    """The matmul precision a solver's loop runs at: the global override if
    set, else ``"highest"`` for every solver (``alg`` is the solver options
    object; every solver shares the policy)."""
    return matmul_precision or "highest"


def precision_scope(value: str | None):
    """Context manager applying a jax matmul precision (None = no-op)."""
    if value is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(value)


#: GreedyCD compaction-cascade knobs (shrink factor per level, smallest
#: buffer, and the row count below which compaction is skipped entirely).
#: Defaults were chosen from the config4 trip histogram
#: (benchmarks/greedycd_trips.py); env-seeded so benchmarks can sweep them
#: in fresh processes (``NMF_TPU_CASCADE_SHRINK`` / ``_MIN`` / ``_OFF_ROWS``).
#: The knobs are read at *trace* time; ``set_greedycd_cascade`` clears the
#: jit caches on change so later solves retrace with the new schedule.
greedycd_cascade: dict[str, int] = {
    "shrink": _env_int("NMF_TPU_CASCADE_SHRINK", 4, 2),
    "min": _env_int("NMF_TPU_CASCADE_MIN", 128, 1),
    "off_rows": _env_int("NMF_TPU_CASCADE_OFF_ROWS", 4096, 1),
    # above this many rows the update runs as a lax.map over row slabs
    # (memory: the full-width G/S/D scratch is 4 (rows x k) f32 arrays —
    # 8 GB at 2M x 256); 512k rows ~= 2 GB of scratch at k=256
    "slab_rows": _env_int("NMF_TPU_CASCADE_SLAB_ROWS", 524_288, 1),
}

#: FNNLS compaction-cascade knobs (ops/fnnls.py) — same machinery as the
#: GreedyCD cascade, over the NNLS right-hand-side columns: ``off_cols`` is
#: the column count below which the plain masked loop runs uncompacted.
#: Trace-time constants like the GreedyCD knobs.
#: FNNLS compaction-cascade schedule — trace-time constants like the
#: GreedyCD knobs; change via :func:`set_fnnls_cascade` (which clears the
#: jit caches), never by mutating this dict after a jitted caller traced.
fnnls_cascade: dict[str, int] = {
    "shrink": _env_int("NMF_TPU_FNNLS_SHRINK", 4, 2),
    "min": _env_int("NMF_TPU_FNNLS_MIN", 256, 1),
    "off_cols": _env_int("NMF_TPU_FNNLS_OFF_COLS", 2048, 1),
}


def set_fnnls_cascade(shrink: int | None = None, min: int | None = None,
                      off_cols: int | None = None):
    """Override the FNNLS cascade schedule (None = keep current).  Same
    trace-time contract as :func:`set_greedycd_cascade`: a change drops the
    jit caches so already-traced SPA/FNNLS programs retrace with the new
    schedule instead of silently keeping the old one."""
    changed = False
    for key, val in (("shrink", shrink), ("min", min), ("off_cols", off_cols)):
        if val is not None:
            if not isinstance(val, int) or val < (2 if key == "shrink" else 1):
                raise ValueError(f"cascade {key} must be an int >= "
                                 f"{2 if key == 'shrink' else 1}")
            changed |= fnnls_cascade[key] != val
            fnnls_cascade[key] = val
    if changed:
        jax.clear_caches()


def set_greedycd_cascade(shrink: int | None = None, min: int | None = None,
                         off_rows: int | None = None,
                         slab_rows: int | None = None):
    """Override the GreedyCD cascade schedule (None = keep current).

    The knobs are trace-time constants, so changing them drops jax's jit
    caches (``jax.clear_caches()``) — otherwise an already-traced solve of
    the same shape would silently keep the old schedule."""
    changed = False
    for key, val in (("shrink", shrink), ("min", min), ("off_rows", off_rows),
                     ("slab_rows", slab_rows)):
        if val is not None:
            if not isinstance(val, int) or val < (2 if key == "shrink" else 1):
                raise ValueError(f"cascade {key} must be an int >= "
                                 f"{2 if key == 'shrink' else 1}")
            changed |= greedycd_cascade[key] != val
            greedycd_cascade[key] = val
    if changed:
        jax.clear_caches()


#: Compilation cache used when ``JAX_COMPILATION_CACHE_DIR`` is not set:
#: a fixed directory inside the checkout (``.gitignore`` lists it).  The
#: path is part of the cache's key, so it never depends on a temporary
#: name, a process id or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> str:
    """Persist XLA compilations to disk so cold-start costs (e.g. the
    nndsvdar init's QR/SVD pipeline) are paid once per machine, not once
    per process, caching every entry (no minimum compile time or size).

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (jax
    reads it itself; no other directory is set), else
    :data:`DEFAULT_CACHE_DIR`.  Returns the directory in use.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
