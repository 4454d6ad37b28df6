"""Multi-process distributed solve: two local processes form a jax.distributed
cluster (CPU backend, 4 virtual devices each -> 8-device global mesh) and run
a sharded solve.  This exercises the exact multi-host code path
(jax.distributed.initialize + GSPMD over a global mesh) that several hosts
use, minus the interconnect."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, sys.argv[4])
from nmf_tpu.models.common import _solve_while
from nmf_tpu.models.multupd import MultUpdate
from nmf_tpu.parallel.mesh import make_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

ndev = len(jax.devices())
assert ndev == 8, f"expected 8 global devices, got {ndev}"
mesh = make_mesh((2, 4))

rng = np.random.default_rng(0)
p, n, k = 64, 64, 4
Xh = rng.random((p, n)).astype(np.float32)
Wh = rng.random((p, k)).astype(np.float32)
Hh = rng.random((k, n)).astype(np.float32)

def put(arr, spec):
    return jax.make_array_from_callback(
        arr.shape,
        NamedSharding(mesh, spec),
        lambda idx: arr[idx],
    )

X = put(Xh, P("rows", "cols"))
W = put(Wh, P("rows", None))
H = put(Hh, P(None, "cols"))

out = _solve_while(
    MultUpdate(obj="mse"), X, W, H, jnp.asarray(10, jnp.int32),
    jnp.asarray(1e-30, jnp.float32),
)
objv = float(out[4])
niters = int(out[2])
print(f"RESULT {sys.argv[3]} {niters} {objv:.8e}", flush=True)
"""


@pytest.mark.skipif(os.environ.get("NMF_TPU_SKIP_MULTIHOST") == "1", reason="disabled")
def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(worker),
                coord,
                "2",
                str(i),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=300)
        outs.append(out)
        assert pr.returncode == 0, out

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, niters, objv = line.split()
                results[pid] = (int(niters), float(objv))
    assert set(results) == {"0", "1"}, outs
    # both processes agree on the global result
    assert results["0"] == results["1"]
    assert results["0"][0] == 10
    assert np.isfinite(results["0"][1])


_SPARSE_WORKER = r"""
import os, sys
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, sys.argv[4])
import nmf_tpu
from nmf_tpu.ops.sparse_shard import shard_tiled, sharded_mm
from nmf_tpu.parallel.mesh import make_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

pid = jax.process_index()
mesh = make_mesh((2, 4))
R, C = 2, 4

rng = np.random.default_rng(0)  # same stream everywhere: same global COO
p, n, k = 300, 260, 5
Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.07)).astype(np.float32)
r, c = np.nonzero(Xd)
v = Xd[r, c]

# process-local slice: keep ONLY the nnz of blocks owned by this process
local_p = -(-p // R)
local_n = -(-n // C)
dev = np.asarray(mesh.devices)
own = np.asarray([[dev[i, j].process_index == pid for j in range(C)] for i in range(R)])
m = own[r // local_p, c // local_n]
nnz_local, nnz_total = int(m.sum()), len(v)

X = shard_tiled(r[m], c[m], v[m], (p, n), mesh, local=True)

# memory: this process materializes ~its share of the entries
seen = set()
loc = 0
for s in X.vals.addressable_shards:
    key = tuple((sl.start, sl.stop) for sl in s.index)
    if key not in seen:
        seen.add(key)
        loc += int(np.prod(s.data.shape))
frac = loc / X.vals.size

# sharded product matches dense on this process's output shards
Dh = rng.random((n, 8)).astype(np.float32)
D = jax.make_array_from_callback(
    Dh.shape, NamedSharding(mesh, P()), lambda idx: Dh[idx]
)
out = sharded_mm(X, D)
ref = Xd @ Dh
ok = all(
    np.allclose(np.asarray(s.data), ref[s.index], rtol=3e-5, atol=1e-4)
    for s in out.addressable_shards
)

# the per-nnz path (multdiv) runs multi-host and both processes agree
def put(arr, spec):
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
    )
W0 = put(rng.random((p, k)).astype(np.float32), P("rows", None))
H0 = put(rng.random((k, n)).astype(np.float32), P(None, "cols"))
res = nmf_tpu.solve(nmf_tpu.MultUpdate(obj="div", maxiter=3), X, W0, H0)

# load stats are SPMD (every process participates) and multi-process safe
from nmf_tpu.ops.sparse_shard import sharded_load_stats
stats_total = int(sharded_load_stats(X)["total_nnz"].sum())

print(
    f"RESULT {pid} {int(ok)} {frac:.4f} {nnz_local} {nnz_total} "
    f"{res.objvalue:.8e} {stats_total}",
    flush=True,
)
"""


@pytest.mark.skipif(os.environ.get("NMF_TPU_SKIP_MULTIHOST") == "1", reason="disabled")
def test_two_process_local_shard_build(tmp_path):
    """shard_tiled(local=True): each process bins only its own nnz, holds only
    ~1/P of the entries, and the sharded products + multdiv per-nnz path
    agree with dense / across processes."""
    worker = tmp_path / "worker.py"
    worker.write_text(_SPARSE_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(i), repo],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
            cwd=repo,
        )
        for i in range(2)
    ]
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=300)
        outs.append(out)
        assert pr.returncode == 0, out

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                (_, pid, ok, frac, nnz_local, nnz_total, objv,
                 stats_total) = line.split()
                results[pid] = (int(ok), float(frac), int(nnz_local),
                                int(nnz_total), float(objv),
                                int(stats_total))
    assert set(results) == {"0", "1"}, outs
    for pid, (ok, frac, nnz_local, nnz_total, objv, st) in results.items():
        assert ok == 1
        assert frac <= 0.75, f"process {pid} materialized {frac:.0%} of entries"
        assert nnz_local < nnz_total
        assert np.isfinite(objv)
        # every process sees the full (replicated) per-block count table
        assert st == nnz_total
    # the two local nnz sets partition the matrix
    assert results["0"][2] + results["1"][2] == results["0"][3]
    # both processes agree on the global objective
    assert np.isclose(results["0"][4], results["1"][4], rtol=1e-6)


_CKPT_WORKER = r"""
import os, sys
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, sys.argv[4])
ckdir = sys.argv[5]

# already-initialized no-op branch of init_distributed
from nmf_tpu.parallel.mesh import init_distributed, make_mesh
init_distributed(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

import nmf_tpu
from nmf_tpu.models.checkpoint import latest_checkpoint, solve_checkpointed
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh((2, 4))
rng = np.random.default_rng(0)
p, n, k = 64, 48, 4
Xh = rng.random((p, n)).astype(np.float32)
Wh = rng.random((p, k)).astype(np.float32)
Hh = rng.random((k, n)).astype(np.float32)

def put(arr, spec):
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
    )

X = put(Xh, P("rows", "cols"))
W = put(Wh, P("rows", None))
H = put(Hh, P(None, "cols"))

alg = nmf_tpu.MultUpdate(obj="mse", maxiter=20, tol=1e-12)
plain = nmf_tpu.solve(alg, X, W, H)

# first 10 iterations with checkpoints, "crash", then resume to 20
partial = nmf_tpu.MultUpdate(obj="mse", maxiter=10, tol=1e-12)
solve_checkpointed(partial, X, W, H, checkpoint_dir=ckdir, checkpoint_every=5)
assert latest_checkpoint(ckdir)[1] == 10

# simulate a crash BETWEEN the two processes' saves: process 0 lost its
# step-10 file, so the processes' latest steps disagree (10 vs 5).  The
# agreement protocol must resume BOTH from step 5 (the largest step present
# on every process) — per-process latest would desynchronize the collectives.
from nmf_tpu.models.checkpoint import agreed_checkpoint
if jax.process_index() == 0:
    os.remove(os.path.join(ckdir, "ckpt_10.proc0.npz"))
ag = agreed_checkpoint(ckdir)
assert ag is not None and ag[1] == 5, ag
res = solve_checkpointed(alg, X, W, H, checkpoint_dir=ckdir, checkpoint_every=5)
assert latest_checkpoint(ckdir)[1] == 20

def shards_equal(a, b):
    def key(s, shape):
        return tuple(
            (0 if sl.start is None else sl.start, d if sl.stop is None else sl.stop)
            for sl, d in zip(s.index, shape)
        )
    sa = {key(s, a.shape): np.asarray(s.data) for s in a.addressable_shards}
    return all(
        np.allclose(sa[key(s, b.shape)], np.asarray(s.data), rtol=1e-6)
        for s in b.addressable_shards
    )

ok = int(
    res.niters == plain.niters
    and shards_equal(res.W, plain.W)
    and shards_equal(res.H, plain.H)
)
print(f"RESULT {sys.argv[3]} {res.niters} {res.objvalue:.8e} {plain.objvalue:.8e} {ok}", flush=True)
"""


@pytest.mark.skipif(os.environ.get("NMF_TPU_SKIP_MULTIHOST") == "1", reason="disabled")
def test_two_process_checkpoint_resume(tmp_path):
    """Multi-host-safe checkpointing: each process saves only its own shards
    (ckpt_*.procN.npz), resume mid-solve reproduces the uninterrupted Result
    bit-for-bit per shard."""
    worker = tmp_path / "worker.py"
    worker.write_text(_CKPT_WORKER)
    ckdir = tmp_path / "ck"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(i), repo, str(ckdir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
            cwd=repo,
        )
        for i in range(2)
    ]
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=300)
        outs.append(out)
        assert pr.returncode == 0, out

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, niters, objv, plain_objv, ok = line.split()
                results[pid] = (int(niters), float(objv), float(plain_objv), int(ok))
    assert set(results) == {"0", "1"}, outs
    for pid, (niters, objv, plain_objv, ok) in results.items():
        assert niters == 20
        assert np.isclose(objv, plain_objv, rtol=1e-10)
        assert ok == 1
    # every process wrote its own shard files, nobody wrote the other's
    names = sorted(os.listdir(ckdir))
    assert any(".proc0.npz" in n for n in names)
    assert any(".proc1.npz" in n for n in names)
