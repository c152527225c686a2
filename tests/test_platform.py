"""Backend-independent behaviour and the GPU entry points, on the CPU.

``auto`` must mean native f64 and dense / host-LU on every backend; the
compile cache must go where ``JAX_COMPILATION_CACHE_DIR`` says, else to
one fixed in-checkout path, without touching a backend; the native mesh
kernels must build atomically; ``chip_smoke.py`` and ``bench.py`` must
refuse to run without a GPU; and the smoke script's backend checks are
rehearsed here at a tiny size."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from sanm_tpu.solver.anm import HyperParam, _ANMDriverBase
from sanm_tpu.taylor_scan import ScanEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_py(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
    out = subprocess.run([sys.executable, "-c", code], env=full, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_uses_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and the in-checkout default is never created."""
    env_dir, default = tmp_path / "env", tmp_path / "default"
    got = _run_py(
        "import json, jax, jax.numpy as jnp, sanm_tpu\n"
        "sanm_tpu.DEFAULT_CACHE_DIR = %r\n"
        "d = sanm_tpu.enable_compile_cache()\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready()\n"
        "print(json.dumps(d))" % str(default),
        JAX_COMPILATION_CACHE_DIR=str(env_dir),
    )
    assert got == str(env_dir)
    assert os.listdir(env_dir), "no cache entry written"
    assert not default.exists()


def test_compile_cache_default_dir_without_backend():
    """Unset: one fixed path inside the checkout, the same on every
    call, and no JAX backend initialised to name it."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = (
        "import json, sanm_tpu\n"
        "from jax._src import xla_bridge\n"
        "a = sanm_tpu.enable_compile_cache()\n"
        "b = sanm_tpu.enable_compile_cache()\n"
        "print(json.dumps([a, b, xla_bridge.backends_are_initialized()]))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    a, b, initialised = json.loads(out.stdout.strip().splitlines()[-1])
    assert a == b == os.path.join(REPO, ".jax_cache")
    assert not initialised


@pytest.mark.parametrize("n, mode", [(100, "dense"), (5000, "host_lu")])
def test_auto_is_backend_independent(monkeypatch, n, mode):
    """On a GPU (or any backend) auto picks dense below dense_limit,
    host LU above it, and native f64 graph passes."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    drv = _ANMDriverBase.__new__(_ANMDriverBase)
    drv.hp = HyperParam()
    drv.n = n
    assert drv._solver_mode() == mode
    assert drv._pass_dtype() == jnp.float64


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wreduce_is_tensordot_sum(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(7).astype(dtype)
    terms = rng.standard_normal((7, 5, 3, 3)).astype(dtype)
    got = np.asarray(ScanEngine._wreduce(jnp.asarray(w),
                                         jnp.asarray(terms)))
    ref = np.einsum("i,iabc->abc", w.astype(np.float64),
                    terms.astype(np.float64))
    tol = 1e-5 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("mode", chip_smoke.BACKENDS)
def test_smoke_anm_step_each_backend(mode):
    """chip_smoke's per-backend ANM step, on a tiny cuboid: the
    requested backend is the one that ran, with no fallback."""
    s = chip_smoke.anm_step(mode, 4, 3, 3, 0.025)
    assert s.residual_rms() < 1.0


def _cuboid_system():
    from sanm_tpu.fea import EnergyModel
    from sanm_tpu.solver.remap import SparseAssembler
    from sanm_tpu.taylor import batched_jacobian

    body, _ = chip_smoke.cuboid_problem(4, 3, 3, 0.025)
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    gin0 = model.lt_inp.remap.apply(jnp.asarray(model.x0()))
    J = batched_jacobian(model.fn, gin0)
    asm = SparseAssembler(model.lt_out.remap, model.lt_inp.remap,
                          gin0.shape[0], 9, 9, model.lt_inp.n_unknown_vtx)
    return asm, asm.assemble_csr(J)[0]


@pytest.mark.parametrize("mode", ["dense_chol", "band_chol"])
def test_smoke_factor_matches_splu(mode):
    """chip_smoke's device-factor check: f32 factor + f64 refinement
    reaches SciPy splu to 1e-10 within a few refinement steps."""
    asm, data = _cuboid_system()
    err, steps, rel = chip_smoke.factor_vs_splu(asm, data, mode)
    assert err <= chip_smoke.SPLU_GATE, err
    assert 1 <= steps <= 8
    assert rel <= 1e-13


def test_native_build_is_atomic(tmp_path, monkeypatch):
    """The shared object appears under its final name only once it is
    complete, and no temporary file is left beside it."""
    from sanm_tpu import native

    so = tmp_path / "_mesh_kernels.so"
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    try:
        native._build()
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("no g++ on this host")
    assert so.exists()
    assert os.listdir(tmp_path) == [so.name]


def test_native_build_failure_falls_back(tmp_path, monkeypatch, capsys):
    """A failed build prints one line and leaves the Python builders."""
    from sanm_tpu import native

    monkeypatch.setattr(native, "_SO", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)

    def broken():
        raise OSError("g++ not found")

    monkeypatch.setattr(native, "_build", broken)
    assert native.get_lib() is None
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "Python builders" in err[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", chip_smoke.BACKENDS)
def test_anm_step_on_gpu(gpu_device, mode):
    """On a card: each explicit backend runs as requested."""
    s = chip_smoke.anm_step(mode, 4, 3, 3, 0.025)
    assert np.isfinite(s.residual_rms())
