"""App-level smoke tests: the CLI tasks run end-to-end on reference
configs (the reference's CPU-runnable e2e config,
``config/test_simple_cuboid_twist.json``, per SURVEY §4)."""

import json
import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow

CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"
)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run_cli(*argv):
    from sanm_tpu.fea.app import do_main

    return do_main(list(argv))


def test_simple_cuboid_twist(workdir):
    # ARAP + implicit continuation + refinement (the reference's
    # CPU-runnable end-to-end config)
    run_cli(
        os.path.join(CONFIGS, "sys.json"),
        os.path.join(CONFIGS, "test_simple_cuboid_twist.json"),
    )
    stat = json.load(open(workdir / "cuboid-twist.json"))
    assert stat["force_rms_recomp"] < 1e-10
    assert stat["nr_inverted"] == 0
    assert (workdir / "cuboid-twist-1.obj").exists()


def test_single_tet_inverse_with_override(workdir):
    # config layering: later files override earlier (fea/main.cpp:1074-1079)
    run_cli(
        os.path.join(CONFIGS, "sys.json"),
        os.path.join(CONFIGS, "test_single_tet_inverse.json"),
        os.path.join(CONFIGS, "override_order16.json"),
    )
    stat = json.load(open(workdir / "test.stl-i1-neohookean_i.json"))
    assert stat["order"] == 16
    assert stat["force_rms_recomp"] < 1e-9


def test_small_cuboid_l2_penalty(workdir, tmp_path):
    # Tikhonov-regularized coefficient solve (override_l2_penalty.json)
    cfg = {
        "func": "test_cuboid",
        "material": {
            "type": "young_poisson", "young": 1e7, "poisson": 0.45,
        },
        "energy_model": "neohookean_c",
        "spacing": 0.025,
        "x": 3, "y": 2, "z": 2,
        "order": 8,
        "out_filename": "cub_l2",
        "xcoeff_l2_penalty": 1e-5,
        "disable_anm_sanity_check": True,
    }
    p = tmp_path / "task.json"
    p.write_text(json.dumps(cfg))
    run_cli(os.path.join(CONFIGS, "sys.json"), str(p))
    stat = json.load(open(workdir / "cub_l2-i0-neohookean_c.json"))
    assert stat["force_rms_recomp"] < 1e-9


def test_unknown_func_raises(workdir, tmp_path):
    from sanm_tpu.utils import SANMError

    p = tmp_path / "task.json"
    p.write_text(json.dumps({"func": "nope"}))
    with pytest.raises(SANMError):
        run_cli(os.path.join(CONFIGS, "sys.json"), str(p))


def test_warm_resolve_compile_guard(workdir, monkeypatch, tmp_path):
    """Hot-loop discipline tripwire (SANM_COMPILE_GUARD): a warm
    re-solve on a long-lived solver must not trigger any new XLA
    compilation — the XLA analog of the reference's
    allocation-in-hot-loop guard (EIGEN_RUNTIME_NO_MALLOC,
    libsanm/tensor_impl_helper.h:12,45-64)."""
    cfg = {
        "func": "gravity",
        "material": {
            "type": "young_poisson", "young": 680000, "poisson": 0.45,
            "density": 958.125,
        },
        "energy_model": "neohookean_c",
        "mesh": os.path.join(CONFIGS, "model", "beam3_tet.1"),
        "g": [0, -9.81, 0],
        "order": 6,
        "out_filename": "bar_cg",
    }
    p = tmp_path / "task.json"
    p.write_text(json.dumps(cfg))
    monkeypatch.setenv("SANM_WARM_TIMING", "1")
    monkeypatch.setenv("SANM_COMPILE_GUARD", "1")  # raise on violation
    run_cli(os.path.join(CONFIGS, "sys.json"), str(p))
    stat = json.load(open(workdir / "bar_cg-i0-neohookean_c.json"))
    assert stat["time_solve_warm"] > 0


def test_compile_guard_unit():
    import jax
    import jax.numpy as jnp

    from sanm_tpu.utils import SANMError, compile_guard

    f = jax.jit(lambda x: x * 2 + 1)
    f(jnp.ones(3))
    with compile_guard():
        f(jnp.ones(3))  # warm: no compile
    with pytest.raises(SANMError):
        with compile_guard(tag="unit"):
            jax.jit(lambda x: x * 3.5)(jnp.ones(3))
    # allow budget tolerates known lazy-compile sites
    with compile_guard(allow=1):
        jax.jit(lambda x: x * 4.5)(jnp.ones(3))
