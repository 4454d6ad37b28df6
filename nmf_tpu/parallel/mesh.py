"""Device-mesh construction for sharded NMF.

The workload's two scalable dimensions are p (rows of X/W) and n (cols of
X/H); k stays replicated (SURVEY.md §2B).  We therefore use a 2-D logical
mesh with axes ("rows", "cols").  The cards of one host reach each other
all to all at one rate (NVLink), so the mesh is a plain reshape of the
device list and follows the algorithm alone; multi-host process bootstrap
goes through ``jax.distributed.initialize`` (see ``init_distributed``).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "auto_mesh_shape", "init_distributed", "ROWS", "COLS"]

ROWS = "rows"
COLS = "cols"


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor ``n_devices`` into the most-square (rows, cols) grid."""
    r = int(math.isqrt(n_devices))
    while n_devices % r:
        r -= 1
    return (r, n_devices // r)


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """Build a ("rows", "cols") mesh over ``devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = auto_mesh_shape(len(devices))
    if shape[0] * shape[1] != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devices)} devices"
        )
    return Mesh(np.array(devices).reshape(shape), axis_names=(ROWS, COLS))


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host bootstrap: thin wrapper over ``jax.distributed.initialize``.
    Safe to call when already initialized (no-op)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
