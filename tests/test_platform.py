"""The GPU port on the CPU: the Triton SDDMM in the Pallas interpreter, the
per-platform choice of the SDDMM, the compile cache's directory, the
environment knobs, the mesh, and the entry points that must refuse to run
without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nmf_tpu.ops.sddmm_kernel import sddmm_reference, sddmm_triton
from nmf_tpu.ops.tiled import entries_sddmm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entries(kind, rng, p=300, n=200):
    if kind == "powerlaw":  # heavy head rows, long tail, sorted by row
        r = np.minimum((rng.pareto(1.1, 5000) * 5).astype(np.int64), p - 1)
        c = rng.integers(0, n, 5000)
    elif kind == "empty-rows":  # every other row and the last 100 empty
        r = rng.integers(0, (p - 100) // 2, 3000) * 2
        c = rng.integers(0, n, 3000)
    else:  # "ragged": an entry count no block size divides
        r = rng.integers(0, p, 4099)
        c = rng.integers(0, n, 4099)
    key = np.unique(r * n + c)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


@pytest.mark.parametrize(
    "kind,k,block",
    [("powerlaw", 9, 32), ("empty-rows", 128, 32), ("ragged", 9, 64),
     ("ragged", 16, 16)],
)
def test_sddmm_triton_interpret_matches_reference(kind, k, block):
    """The Triton SDDMM, run in the Pallas interpreter, matches the plain
    gather-gather-reduce and float64 numpy: power-law and empty rows, k
    that is not a power of two (padded to one inside), entry counts no
    block size divides (padded entries are cut off)."""
    rng = np.random.default_rng(0)
    p, n = 300, 200
    r, c = _entries(kind, rng, p, n)
    W = rng.random((p, k)).astype(np.float32)
    Ht = rng.random((n, k)).astype(np.float32)
    got = np.asarray(sddmm_triton(jnp.asarray(r), jnp.asarray(c),
                                  jnp.asarray(W), jnp.asarray(Ht),
                                  block=block, interpret=True))
    want = np.einsum("ik,ik->i", W.astype(np.float64)[r],
                     Ht.astype(np.float64)[c])
    assert got.shape == (len(r),)
    np.testing.assert_allclose(got, want, rtol=2e-6)
    ref = np.asarray(sddmm_reference(r, c, W, Ht))
    np.testing.assert_allclose(got, ref, rtol=2e-6)


def _lowered(platform):
    from jax import export

    r = jnp.zeros(1000, jnp.int32)
    W = jnp.ones((50, 9), jnp.float32)
    exp = export.export(
        jax.jit(entries_sddmm), platforms=[platform],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(r, r, W, W)
    return exp.mlir_module()


def test_sddmm_seam_picks_kernel_by_platform():
    """Lowered for CUDA the seam runs the Triton kernel; lowered for the CPU
    it runs the plain reference — no kernel, no interpreter."""
    assert "__gpu$xla.gpu.triton" in _lowered("cuda")
    cpu = _lowered("cpu")
    assert "custom_call" not in cpu and "triton" not in cpu
    # and what the CPU actually runs is the reference
    rng = np.random.default_rng(1)
    r, c = _entries("ragged", rng)
    W = jnp.asarray(rng.random((300, 5)).astype(np.float32))
    Ht = jnp.asarray(rng.random((200, 5)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(entries_sddmm)(r, c, W, Ht)),
        np.asarray(jax.jit(sddmm_reference)(r, c, W, Ht)))


def _python(code, env_extra=(), cwd=ROOT, args=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "NMF_TPU_DISPATCH_CHUNK")}
    env.update(env_extra)
    cmd = [sys.executable] + (["-c", code] if code else list(args))
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from nmf_tpu import config
print(config.enable_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.arange(7.0)).block_until_ready()
"""


def test_compilation_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there and
    no other directory is set."""
    out = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    used, configured = out.stdout.split()[:2]
    assert used == configured == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_compilation_cache_default_is_fixed_in_checkout():
    """Without the variable the cache is one fixed directory inside the
    checkout, the same in every process."""
    from nmf_tpu import config

    assert config.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    outs = [_python(_CACHE_PROBE) for _ in range(2)]
    for out in outs:
        assert out.returncode == 0, out.stderr
        assert out.stdout.split()[:2] == [config.DEFAULT_CACHE_DIR] * 2
    assert os.listdir(config.DEFAULT_CACHE_DIR)


@pytest.mark.parametrize("value,expected", [("abc", "None"), ("0", "None"),
                                            ("7", "7")])
def test_dispatch_chunk_env_never_breaks_import(value, expected):
    out = _python("from nmf_tpu import config; print(config.dispatch_chunk)",
                  {"NMF_TPU_DISPATCH_CHUNK": value})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == expected


def test_make_mesh_is_a_plain_reshape():
    from nmf_tpu.parallel.mesh import make_mesh

    devs = jax.devices()[:8]
    mesh = make_mesh((2, 4), devices=devs)
    assert mesh.axis_names == ("rows", "cols")
    assert list(np.asarray(mesh.devices).reshape(-1)) == list(devs)
    with pytest.raises(ValueError):
        make_mesh((3, 3), devices=devs)


def test_chip_smoke_refuses_cpu(tmp_path):
    """chip_smoke.py stops before any phase, with a non-zero exit and no
    result line, when JAX's platform is the CPU, and when run outside a
    checkout."""
    import chip_smoke

    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.gpu_device()
    out = _python(None, {"JAX_PLATFORMS": "cpu"},
                  args=[os.path.join(ROOT, "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = _python(None, {"JAX_PLATFORMS": "cpu"}, cwd=tmp_path,
                  args=[str(alone)])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_benchmarks_refuse_cpu_unless_asked(monkeypatch):
    """Without a GPU the benchmarks (bench.py, benchmarks/run.py,
    benchmarks/sparse_kernel.py all call require_gpu first) exit non-zero
    before measuring, unless the caller asked for the CPU with
    JAX_PLATFORMS=cpu; then every row names the CPU."""
    from benchmarks.run import require_gpu

    assert require_gpu() == {"platform": "cpu", "device_kind": "cpu",
                             "device_count": len(jax.devices())}
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()
