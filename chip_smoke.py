#!/usr/bin/env python3
"""Smoke test of the FEA equilibrium solve on NVIDIA GPUs.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card:

* device — refuses anything but a GPU, names the card and its power
  limit;
* main — the reference benchmark (armadillo-small, compressible
  Neo-Hookean, gravity, order 20, Pade, force-RMS 1e-10) through
  ``TASKS["gravity"]``, cold then warm; auto must resolve to the hybrid
  loop with host sparse LU, no fallback, no compile in the warm re-solve;
* arap — the same mesh with the ARAP material (SVD-W Taylor rules), one
  cold solve;
* drivers — the implicit (cuboid twist) and inverse (single tet) tasks;
* backends — the order-0 armadillo-small Jacobian solved with the f32
  device factors + f64 refinement, each compared with SciPy ``splu``;
  then one ANM step on a 12x8x8 cuboid per explicit solver backend.

Four cards (``--four``): the armadillo-small gravity solve with the
element batch sharded over four devices against the one-card solve, and
the row-sharded ``dense_chol`` factor against the unsharded one.

Output files go to ``smoke_out/``.  Any failed check raises, so the
script exits non-zero; only when every phase passed is the last line of
stdout the JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "configs")
OUT_DIR = os.path.join(REPO, "smoke_out")
RMS_GATE = 1e-10  # reference fea/main.cpp:28
SPLU_GATE = 1e-10  # device factor + refinement vs host splu
BACKENDS = ("dense", "host_lu", "dense_chol", "band_chol", "cg")


def log(*args):
    print(*args, flush=True)


def config(*names, out=None):
    from sanm_tpu.fea.app import merge_configs

    cfg = merge_configs([os.path.join(CONFIGS, n) for n in names])
    if out is not None:
        cfg["out_filename"] = os.path.join(OUT_DIR, out)
    return cfg


def mib(nbytes):
    return "%.1f MiB" % (nbytes / 2**20)


def peak_line(dev, what):
    stats = dev.memory_stats() or {}
    return "%s: device %d peak_bytes_in_use %s (process peak so far)" % (
        what, dev.id, mib(stats.get("peak_bytes_in_use", 0)),
    )


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def device_phase(count):
    """The GPU devices to use; exits non-zero on any other platform."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit("chip_smoke: no GPU (JAX platform %r); refusing to run"
                 % devs[0].platform)
    if len(devs) < count:
        sys.exit("chip_smoke: need %d GPUs, JAX sees %d" % (count, len(devs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    import sanm_tpu

    log("device_kind:", devs[0].device_kind, "x", len(devs))
    for line in smi.splitlines():
        log(line)
    log("jax", jax.__version__, "x64", jax.config.jax_enable_x64)
    assert jax.config.jax_enable_x64
    log("compile cache:", sanm_tpu.enable_compile_cache())
    return devs


def check_solve(stat, what):
    rms, inv = stat["force_rms_recomp"], stat["nr_inverted"]
    log("%s: force_rms_recomp %.3e nr_inverted %d" % (what, rms, inv))
    assert rms <= RMS_GATE, (what, rms)
    assert inv == 0, (what, inv)


def check_no_fallback(solver, what):
    assert getattr(solver, "_solver_override", None) is None, (
        what, "device-factor fallback fired")
    assert getattr(solver, "_factor_gate_fails", 0) == 0, (
        what, "factor pre-gate failed")


def main_phase(dev):
    from sanm_tpu.fea.app import TASKS
    from sanm_tpu.utils import compile_seconds

    c0 = compile_seconds()
    os.environ["SANM_WARM_TIMING"] = "1"
    try:
        res = TASKS["gravity"](
            config("armadillo_small.json", out="armadillo-small"), CONFIGS
        )
    finally:
        del os.environ["SANM_WARM_TIMING"]
    st = res.stat
    check_solve(st, "main")
    log("main: solver %s loop %s" % (st["solver_resolved"],
                                      st["loop_resolved"]))
    assert st["solver_resolved"] == "host_lu", st["solver_resolved"]
    assert st["loop_resolved"] == "hybrid", st["loop_resolved"]
    check_no_fallback(res.solver, "main")
    assert st["warm_compiles"] == 0, st["warm_compiles"]
    log("main: cold time_solve %.3f s, warm time_solve %.3f s, iter %d, "
        "compile %.1f s (summed over threads), warm compiles %d"
        % (st["time_solve"], st["time_solve_warm"], st["iter"],
           compile_seconds() - c0, st["warm_compiles"]))
    log(peak_line(dev, "main"))
    # the fused order step (commit k + bias k+1), one executable per
    # argument signature (k=1 without caches, k>=2 with)
    step_fn = res.solver._hybrid_fns()[3]
    for i, ma in enumerate(step_fn.memory_analyses()):
        log("main: order-step program %d memory_analysis: argument %s, "
            "output %s, alias %s, temp %s, code %s"
            % (i, mib(ma.argument_size_in_bytes),
               mib(ma.output_size_in_bytes), mib(ma.alias_size_in_bytes),
               mib(ma.temp_size_in_bytes),
               mib(ma.generated_code_size_in_bytes)))


def arap_phase(dev):
    from sanm_tpu.fea.app import TASKS

    # the reference protocol runs ARAP gravity with a 2.5x stiffer
    # material (render/cmp_with_baseline.sh:44-46): with the soft one
    # the continuation walks into collapsing elements
    res = TASKS["gravity"](
        config("armadillo_small.json", "override_arap.json",
               "override_stiff_material.json", out="armadillo-small-arap"),
        CONFIGS,
    )
    st = res.stat
    check_solve(st, "arap")
    log("arap: cold time_solve %.3f s, iter %d, solver %s loop %s"
        % (st["time_solve"], st["iter"], st["solver_resolved"],
           st["loop_resolved"]))
    log(peak_line(dev, "arap"))


def drivers_phase():
    from sanm_tpu.fea.app import TASKS

    twist = TASKS["test_cuboid_twist"](
        config("test_simple_cuboid_twist.json", out="cuboid-twist"), CONFIGS
    ).stat
    check_solve(twist, "implicit twist")
    cfg = config("test_single_tet_inverse.json", out="single-tet")
    res = TASKS["test_single_tet_inverse"](cfg, CONFIGS)
    check_solve(res.stat, "inverse")
    # the rest shape that sags onto the loaded shape is taller than it
    apex = float(res.mesh.vertices[3, 2])
    log("inverse: apex z %.6f (loaded %.6f)" % (apex, cfg["spacing"]))
    assert apex > float(cfg["spacing"]), apex


def build_system(cfg):
    """Order-0 Jacobian of a gravity config's forward model: the
    assembler, the CSR values and the model."""
    import jax.numpy as jnp

    from sanm_tpu.fea.app import energy_model_of, gravity_body
    from sanm_tpu.solver.remap import SparseAssembler
    from sanm_tpu.taylor import batched_jacobian

    _, body, _, _ = gravity_body(cfg, CONFIGS)
    model = body.make_forward(energy_model_of(cfg))
    rin, rout = model.lt_inp.remap, model.lt_out.remap
    gin0 = rin.apply(jnp.asarray(model.x0()))
    J = batched_jacobian(model.fn, gin0)
    asm = SparseAssembler(rout, rin, gin0.shape[0], 9, 9,
                          model.lt_inp.n_unknown_vtx)
    data, _ = asm.assemble_csr(J)
    return asm, data


def factor_vs_splu(asm, data, mode, seed=0):
    """Solve A x = b through a device factor (``dense_chol`` or
    ``band_chol``) with f64 refinement; returns (relative error vs
    SciPy splu, refinement steps, relative residual)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from sanm_tpu.jit_util import jit_hoist_consts
    from sanm_tpu.solver.band import DeviceBandCholSolver, band_tri_solve_fn
    from sanm_tpu.solver.linear import DeviceCholSolver, chol_refine_solve

    if mode == "dense_chol":
        solver = DeviceCholSolver(asm, data)
        tri = None
    else:
        solver = DeviceBandCholSolver(asm, data)
        tri = band_tri_solve_fn(solver.plan)
    assert solver.factor_ok(), mode
    b = np.random.default_rng(seed).standard_normal(asm.n)
    # refine down to the f64 floor (rtol 1e-13, at most 50 steps): an
    # ill-conditioned system stops at the cap, a well-conditioned one
    # early; the step count says how far the fused device loop's cap
    # (SANM_REFINE_STEPS, 8) is from what this system needs
    solve = jit_hoist_consts(lambda L, s, d, b: chol_refine_solve(
        L, s, d, b, asm.matvec, 50, tri_solve=tri, rtol=1e-13,
        with_resid=True,
    ))
    x, rel, steps = solve(solver._L, solver._s, data, jnp.asarray(b))
    A = sp.csr_matrix((np.asarray(data), (asm.csr_rowidx, asm.csr_cols)),
                      shape=(asm.n, asm.n))
    x_ref = spla.splu(A.tocsc()).solve(b)
    x = np.asarray(x)
    err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
    return err, int(steps), float(rel)


def cuboid_problem(nx, ny, nz, spacing):
    from sanm_tpu.fea import DeformableBody, MaterialProperty
    from sanm_tpu.fea import TetrahedralMesh

    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= spacing / 2, :] = True
    f_load = np.zeros((mesh.nr_vertices, 3))
    sel = mesh.vertices[:, 0] > (nx - 1) * spacing - spacing / 2
    f_load[sel, 2] = -30.0
    return body, f_load


def anm_step(mode, nx=12, ny=8, nz=8, spacing=0.02, order=6, shard=None):
    """One ANM restart with ``solver=mode`` on a loaded cuboid (NHC);
    asserts that ``mode`` is what ran, with no fallback.  Returns the
    solver."""
    from sanm_tpu.fea import EnergyModel
    from sanm_tpu.solver import ANMEqnSolver
    from sanm_tpu.solver.anm import EqnHyperParam

    body, f_load = cuboid_problem(nx, ny, nz, spacing)
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    hp = EqnHyperParam(order=order, use_pade=True, solver=mode)
    hp.converge_rms = RMS_GATE
    ctx = shard.mesh if shard is not None else contextlib.nullcontext()
    with ctx:
        s = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
            model.lt_inp.copy_vtx_values(f_load), hp, shard_elems=shard,
        )
        s.next_iter()
    assert s._solver_mode() == mode, (mode, s._solver_mode())
    check_no_fallback(s, mode)
    if mode in ("dense_chol", "band_chol"):
        # an indefinite factor falls back to host LU without a flag
        assert s._fact_dev is not None, (mode, "device factor unused")
    assert np.isfinite(s.residual_rms()), mode
    return s


def equilibrated_condition(asm, data):
    """2-norm condition number of ``-D A D`` (the SPD matrix the device
    factors see), from its extreme eigenvalues; f32 refinement
    converges at a rate of about kappa * 6e-8 per step."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csr_matrix((np.asarray(data), (asm.csr_rowidx, asm.csr_cols)),
                      shape=(asm.n, asm.n))
    d = 1.0 / np.sqrt(np.abs(A.diagonal()))
    M = -(sp.diags(d) @ A @ sp.diags(d)).tocsc()
    hi = spla.eigsh(M, k=1, which="LA", return_eigenvectors=False)[0]
    lo = spla.eigsh(M, k=1, sigma=0, which="LM",
                    return_eigenvectors=False)[0]
    return float(hi / lo)


def backends_phase():
    asm, data = build_system(config("armadillo_small.json"))
    log("backends: armadillo-small order-0 Jacobian n=%d nnz=%d, "
        "kappa(-DAD) %.3e" % (asm.n, asm.nnz,
                              equilibrated_condition(asm, data)))
    for mode in ("dense_chol", "band_chol"):
        t = time.perf_counter()
        err, steps, rel = factor_vs_splu(asm, data, mode)
        log("backends: %s vs splu: rel err %.3e, refinement steps %d, "
            "rel residual %.3e (%.1f s incl. compile)"
            % (mode, err, steps, rel, time.perf_counter() - t))
        assert err <= SPLU_GATE, (mode, err)
    for mode in BACKENDS:
        s = anm_step(mode)
        log("backends: ANM step solver=%s loop=%s n=%d residual_rms %.3e"
            % (mode, s._loop_mode(), s.n, s.residual_rms()))


def solve_gravity(cfg, shard=None):
    """Solve a gravity config to RMS_GATE, optionally element-sharded;
    returns (x, solver, recomputed force RMS)."""
    from sanm_tpu.fea.app import (energy_model_of, gravity_body,
                                  run_anm_eqn, setup_solver_param)
    from sanm_tpu.fea.model import DeformableBody
    from sanm_tpu.solver import ANMEqnSolver

    _, body, f_load_full, _ = gravity_body(cfg, CONFIGS)
    model = body.make_forward(energy_model_of(cfg))
    f_sub = model.lt_inp.copy_vtx_values(f_load_full)
    hp = setup_solver_param(cfg, eqn=True)
    hp.solution_check_tol = 1e-3  # as run_and_save
    ctx = shard.mesh if shard is not None else contextlib.nullcontext()
    with ctx:
        s = ANMEqnSolver(model.fn, model.lt_inp.remap, model.lt_out.remap,
                         model.x0(), f_sub, hp, shard_elems=shard)
        x = np.asarray(run_anm_eqn(s, progress=False))
    return x, s, DeformableBody.compute_force_rms(model, x, f_sub)


def four_phase(devs, cfg, cuboid=(12, 8, 8, 0.02)):
    """Sharded paths over ``devs`` against their one-device versions."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from __graft_entry__ import check_factor_row_sharded
    from sanm_tpu.parallel import ElemSharding
    from sanm_tpu.solver.linear import DeviceCholSolver

    n_dev = len(devs)
    x1, s1, rms1 = solve_gravity(cfg)
    shard = ElemSharding(devs)
    x4, s4, rms4 = solve_gravity(cfg, shard)
    rel = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log("four: gravity 1 device rms %.3e iter %d | %d devices rms %.3e "
        "iter %d | positions rel diff %.3e"
        % (rms1, s1.get_nr_iter(), n_dev, rms4, s4.get_nr_iter(), rel))
    assert rms1 <= RMS_GATE and rms4 <= RMS_GATE, (rms1, rms4)
    assert rel <= 1e-8, rel
    assert s1.get_nr_iter() == s4.get_nr_iter()
    # the element batch must live on every device, not on device 0
    E = s4._hybrid_fns()[0](jnp.asarray(s4.xt0))[2]
    placed = {sh.device for sh in E.addressable_shards}
    rows = {sh.data.shape[0] for sh in E.addressable_shards}
    log("four: element stiffness %s on %d devices, %s rows each"
        % (E.shape, len(placed), sorted(rows)))
    assert placed == set(devs), placed
    assert max(rows) < E.shape[0], "element batch replicated, not sharded"
    for d in devs:
        log(peak_line(d, "four"))

    # row-sharded dense_chol: factor layout + solve vs unsharded
    sm = anm_step("dense_chol", *cuboid, shard=shard)
    nrows = check_factor_row_sharded(sm, n_dev)
    asm = sm._assembler()
    data = sm._hybrid_fns()[0](jnp.asarray(sm.xt0))[0]
    mesh = Mesh(np.asarray(devs), ("d",))
    b = jnp.asarray(np.random.default_rng(1).standard_normal(asm.n))
    x_ref = np.asarray(DeviceCholSolver(asm, data).solve(b))
    x_sh = np.asarray(DeviceCholSolver(asm, data, mesh=mesh).solve(b))
    rel = float(np.linalg.norm(x_sh - x_ref) / np.linalg.norm(x_ref))
    log("four: dense_chol factor %d rows -> %d per device; sharded vs "
        "unsharded solve rel diff %.3e" % (nrows, nrows // n_dev, rel))
    assert rel <= 1e-10, rel


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded comparisons")
    args = ap.parse_args()
    count = 4 if args.four else 1
    devs = device_phase(count)
    os.makedirs(OUT_DIR, exist_ok=True)
    from sanm_tpu.utils import compile_seconds

    compile_seconds()  # attach the listener before the first compile
    t0 = time.perf_counter()
    if args.four:
        four_phase(devs[:4], config("armadillo_small.json"))
    else:
        main_phase(devs[0])
        arap_phase(devs[0])
        drivers_phase()
        backends_phase()
    log("all phases passed in %.1f s (compile %.1f s summed over threads)"
        % (time.perf_counter() - t0, compile_seconds()))
    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
