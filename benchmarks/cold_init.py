"""Cold-start cost of the default init (nndsvdar -> rsvd -> CholeskyQR3).

The nndsvdar cold path spends most of its first call compiling the QR/SVD
pipeline.  The persistent compilation cache
(``nmf_tpu.config.enable_compilation_cache``: ``JAX_COMPILATION_CACHE_DIR``
if set, else ``.jax_cache`` in the checkout) makes that a once-per-machine
cost.  This probe measures it:

    python benchmarks/cold_init.py          # first run: populates the cache
    python benchmarks/cold_init.py          # second run: reads it back

Each invocation is a FRESH process, so the second run's "cold" time is the
true cache-hit cost a user pays after restarting.  Pass --no-cache to
measure the uncached baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--p", type=int, default=2000)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args()

    import jax

    from nmf_tpu import config as _config

    if not args.no_cache:
        _config.enable_compilation_cache()

    import jax.numpy as jnp

    import nmf_tpu

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.random((args.p, args.n), dtype=np.float32))
    t0 = time.perf_counter()
    W, H = nmf_tpu.nndsvd(X, args.k, variant="ar", key=jax.random.PRNGKey(0))
    _ = float(W.sum()) + float(H.sum())
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    W, H = nmf_tpu.nndsvd(X, args.k, variant="ar", key=jax.random.PRNGKey(1))
    _ = float(W.sum())
    warm = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "metric": "nndsvdar_cold_init",
                "value": round(cold, 3),
                "unit": "sec_first_call_fresh_process",
                "warm_sec": round(warm, 4),
                "cache": not args.no_cache,
                "backend": jax.default_backend(),
                "shape": [args.p, args.n, args.k],
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
