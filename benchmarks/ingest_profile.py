"""Host ingestion profile: build_tiled wall time by phase at benchmark scale.

Usage:
  python benchmarks/ingest_profile.py [--nnz 90000000] [--p 2000000]
      [--n 200000]

Prints one JSON line per phase (generation excluded) plus the end-to-end
Mnnz/s of the store build: the (row, col) sort of the COO, the column
order, and the copy to the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nnz", type=int, default=90_000_000)
    ap.add_argument("--p", type=int, default=2_000_000)
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args()

    from run import _movielens_like

    from nmf_tpu.io.loader import _load_lib

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rows, cols, vals = _movielens_like(rng, p=args.p, n=args.n, nnz=args.nnz)
    nnz = len(vals)
    gen = time.perf_counter() - t0
    print(json.dumps({"phase": "generate(excluded)", "sec": round(gen, 1),
                      "nnz": nnz, "native_lib": _load_lib() is not None}),
          flush=True)

    import jax

    from nmf_tpu.io.loader import gather3, stable_argsort
    from nmf_tpu.ops.sparse_format import build_tiled

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        print(json.dumps({"phase": name, "sec": round(dt, 2)}), flush=True)
        return out, dt

    (so, t_sort) = phase("row_sort", lambda: stable_argsort(
        rows.astype(np.int64) * args.n + cols))
    ((r1, c1, v1), t_gather) = phase("gather", lambda: gather3(
        so, rows.astype(np.int32), cols.astype(np.int32), vals))
    (_, t_col) = phase("col_order", lambda: stable_argsort(
        c1.astype(np.int64)))
    (X, t_total) = phase("build_tiled", lambda: jax.block_until_ready(
        build_tiled(rows, cols, vals, (args.p, args.n))))
    print(json.dumps({
        "metric": "ingest_rate",
        "value": round(nnz / t_total / 1e6, 2),
        "unit": "Mnnz_per_sec_build_tiled",
        "total_sec": round(t_total, 2),
        "sort_gather_col_sec": round(t_sort + t_gather + t_col, 2),
        "nnz": nnz,
        "device": jax.devices()[0].device_kind,
    }), flush=True)


if __name__ == "__main__":
    main()
