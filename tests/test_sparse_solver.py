"""Sparse assembly + solver backend tests.

The CSR assembler and each linear-solver backend (dense factorization,
host sparse LU, device block-Jacobi PCG) must produce the same ANM
solutions — the backends replace the reference's single PARDISO path
(``libsanm/sparse_solver.cpp``) with size-appropriate strategies.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sanm_tpu.fea import (
    DeformableBody,
    EnergyModel,
    MaterialProperty,
    TetrahedralMesh,
)
from sanm_tpu.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
from sanm_tpu.solver import ANMEqnSolver, ANMImplicitSolver, LinearRemap
from sanm_tpu.solver.anm import EqnHyperParam, HyperParam
from sanm_tpu.solver.remap import SparseAssembler
from sanm_tpu.taylor import batched_jacobian
from helper import require_tensor_eq

MATERIAL = MaterialProperty.from_young_poisson(1e7, 0.45)


def make_problem(nx=4, ny=3, nz=3, spacing=0.025):
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    body = DeformableBody(MATERIAL, mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= spacing / 2, :] = True
    f_load = np.zeros((mesh.nr_vertices, 3))
    sel = mesh.vertices[:, 0] > (nx - 1) * spacing - spacing / 2
    f_load[sel, 2] = -30.0
    return body, f_load


class TestAssembler:
    def test_csr_matches_dense(self):
        body, _ = make_problem()
        model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
        gin0 = model.lt_inp.remap.apply(jnp.asarray(model.x0()))
        J = batched_jacobian(model.fn, gin0)
        B = gin0.shape[0]
        asm = SparseAssembler(
            model.lt_out.remap, model.lt_inp.remap, B, 9, 9,
            model.lt_inp.n_unknown_vtx,
        )
        data, gt = asm.assemble_csr(J)
        assert gt is None
        A_csr = np.asarray(asm.assemble_dense_from_csr(data))
        from sanm_tpu.solver.remap import assemble_dense

        A_ref = np.asarray(
            assemble_dense(
                model.lt_out.remap, J, model.lt_inp.remap,
                model.lt_inp.n_unknown_vtx,
            )
        )
        # margin = matrix scale: stiffness entries cancel to ~0 at some
        # positions, and the element-condensed assembly (Lout J Lin) sums
        # in a different order than the dense slot enumeration — roundoff
        # there is relative to the ~1e5 term magnitudes, not the result
        require_tensor_eq(
            A_csr, A_ref, 1e-12, margin=float(np.abs(A_ref).max()),
            msg="csr vs dense assembly",
        )
        # matvec consistency
        x = np.random.default_rng(0).standard_normal(A_ref.shape[1])
        require_tensor_eq(
            np.asarray(asm.matvec(data, jnp.asarray(x))),
            A_ref @ x,
            1e-10,
            msg="csr matvec",
        )
        require_tensor_eq(
            np.asarray(asm.matvec_t(data, jnp.asarray(x[: A_ref.shape[0]]))),
            A_ref.T @ x[: A_ref.shape[0]],
            1e-10,
            msg="csr matvec_t",
        )

    def test_grad_t_column(self):
        # implicit-mode assembly must split the t column into grad_t
        batch = 5
        rng = np.random.default_rng(1)
        dx = rng.standard_normal(batch)
        rows = [[(i, 1.0), (batch, float(dx[i]))] for i in range(batch)]
        rin = LinearRemap(rows, batch + 1, (batch,))
        rout = LinearRemap.identity(batch)
        J = jnp.asarray(rng.standard_normal((batch, 1, 1)))
        asm = SparseAssembler(rout, rin, batch, 1, 1, batch)
        data, gt = asm.assemble_csr(J)
        assert gt is not None
        A = np.asarray(asm.assemble_dense_from_csr(data))
        require_tensor_eq(
            A, np.diag(np.asarray(J).reshape(-1)), 1e-12, msg="A"
        )
        require_tensor_eq(
            np.asarray(gt), np.asarray(J).reshape(-1) * dx, 1e-12,
            msg="grad_t",
        )


@pytest.mark.slow
@pytest.mark.parametrize(
    "mode", ["host_lu", "cg", "dense_chol", "band_chol"]
)
def test_solver_backends_match_dense(mode):
    body, f_load = make_problem()
    em = EnergyModel.NEOHOOKEAN_C

    def solve(solver_mode):
        model = body.make_forward(em)
        f_sub = model.lt_inp.copy_vtx_values(f_load)
        hp = EqnHyperParam(order=8, use_pade=True, solver=solver_mode)
        hp.converge_rms = RMS_THRESH_FORCE_EQU
        s = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
            f_sub, hp,
        )
        return np.asarray(run_anm_eqn(s, progress=False))

    ref = solve("dense")
    got = solve(mode)
    require_tensor_eq(got, ref, 1e-7, msg=f"{mode} vs dense")


@pytest.mark.slow
def test_factor_pre_gate_fallback(monkeypatch):
    """A device factor whose first refined backsolve misses the quality
    gate must fall back to host LU for the cost of ONE backsolve (no
    full failed expansion) and stay host-LU for the rest of the solve
    (the real case seen: the f32 band factor on jet NHI).  Forcing the
    gate impossible (1e-30) simulates the bad
    factor; the solve must still converge through the fallback."""
    body, f_load = make_problem()
    em = EnergyModel.NEOHOOKEAN_C
    monkeypatch.setenv("SANM_FACTOR_GATE", "1e-30")

    model = body.make_forward(em)
    f_sub = model.lt_inp.copy_vtx_values(f_load)
    hp = EqnHyperParam(order=8, use_pade=True, solver="band_chol")
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    s = ANMEqnSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
        f_sub, hp,
    )
    got = np.asarray(run_anm_eqn(s, progress=False))
    assert getattr(s, "_factor_gate_fails", 0) >= 1
    assert s._solver_override == "host_lu"

    monkeypatch.delenv("SANM_FACTOR_GATE")
    model = body.make_forward(em)
    hp2 = EqnHyperParam(order=8, use_pade=True, solver="dense")
    hp2.converge_rms = RMS_THRESH_FORCE_EQU
    s2 = ANMEqnSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
        f_sub, hp2,
    )
    ref = np.asarray(run_anm_eqn(s2, progress=False))
    require_tensor_eq(got, ref, 1e-7, msg="gate fallback vs dense")


def test_implicit_solver_host_lu():
    # the implicit solver's grad_t path through the sparse assembler
    batch = 5
    rng = np.random.default_rng(2)
    x0 = rng.uniform(1.0, 2.0, batch)
    dx = rng.uniform(-2.0, -1.0, batch)
    rows = [[(i, 1.0), (batch, float(dx[i]))] for i in range(batch)]
    rin = LinearRemap(rows, batch + 1, (batch,))
    rout = LinearRemap.identity(batch)
    solver = ANMImplicitSolver(
        lambda x: x**1.5, rin, rout, x0, 0.0,
        HyperParam(solver="host_lu"),
    )
    it = 0
    while solver.get_t_upper() < 1.0:
        it += 1
        assert it < 20
        solver.update_approx()
    xt, t = solver.eval(solver.solve_a(1.0))
    require_tensor_eq(
        (np.asarray(xt) + dx) ** 1.5, x0**1.5, 1e-4, msg="implicit host_lu"
    )


@pytest.mark.slow
def test_factorization_reuse_across_restarts():
    """Stale-Jacobian restarts (hybrid mode): when the continuation
    point barely moves between error-correcting restarts, the hybrid
    loop reuses the previous factorization (an inexact-Newton scheme,
    no reference analog) and must still converge to the same solution
    as the always-fresh path."""
    body, f_load = make_problem()
    em = EnergyModel.NEOHOOKEAN_C

    def solve(reuse_step):
        model = body.make_forward(em)
        f_sub = model.lt_inp.copy_vtx_values(f_load)
        hp = EqnHyperParam(
            order=8, use_pade=True, solver="host_lu", loop="hybrid",
        )
        hp.converge_rms = RMS_THRESH_FORCE_EQU
        hp.fact_reuse_rel_step = reuse_step
        s = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
            f_sub, hp,
        )
        x = np.asarray(run_anm_eqn(s, progress=False))
        return x, s

    ref, s_off = solve(0.0)
    assert not getattr(s_off, "_last_fact_reused", False)
    got, s_on = solve(1e-2)
    require_tensor_eq(got, ref, 1e-8, msg="fact reuse vs fresh")
    assert s_on.residual_rms() < RMS_THRESH_FORCE_EQU


def test_condensed_remap_applies_match():
    """SparseAssembler.apply_in/apply_out (the element-condensed
    forms used by the hybrid hot loop) must equal the padded-gather
    LinearRemap.apply on both remap directions."""
    body, _ = make_problem()
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    rin, rout = model.lt_inp.remap, model.lt_out.remap
    n = model.lt_inp.n_unknown_vtx
    B = rin.out_shape[0]
    asm = SparseAssembler(rout, rin, B, 9, 9, n)
    rng = np.random.default_rng(0)

    xt = jnp.asarray(rng.standard_normal(n + 1))
    ref_in = rin.apply(xt[:n])
    got_in = asm.apply_in(xt)
    require_tensor_eq(np.asarray(got_in), np.asarray(ref_in), 1e-12,
                      msg="apply_in")

    b = jnp.asarray(rng.standard_normal((B, 3, 3)))
    ref_out = rout.apply(b).reshape(-1)
    got_out = asm.apply_out(b)
    require_tensor_eq(np.asarray(got_out), np.asarray(ref_out), 1e-12,
                      msg="apply_out")


def test_element_matvec_matches_coo():
    """element_matvec (gather-lean refinement matvec from the condensed
    per-element stiffness) must equal the COO matvec in f64 and f32."""
    body, _ = make_problem()
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    gin0 = model.lt_inp.remap.apply(jnp.asarray(model.x0()))
    J = batched_jacobian(model.fn, gin0)
    B = gin0.shape[0]
    n = model.lt_inp.n_unknown_vtx
    asm = SparseAssembler(model.lt_out.remap, model.lt_inp.remap,
                          B, 9, 9, n)
    data, _ = asm.assemble_csr(J)
    E = asm.element_stiffness(J)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(n))
    ref = np.asarray(asm.matvec(data, x))
    got = np.asarray(asm.element_matvec(E, x))
    require_tensor_eq(got, ref, 1e-11, msg="element_matvec f64")
    got32 = np.asarray(
        asm.element_matvec(E.astype(jnp.float32), x.astype(jnp.float32))
    )
    require_tensor_eq(got32.astype(np.float64), ref, 1e-4,
                      msg="element_matvec f32")


def test_device_chol_mesh_matches_single():
    """DeviceCholSolver(mesh=...) — the multi-chip mode with a
    row-sharded factor and blocked substitutions — must reproduce the
    single-device solve on a real FEA stiffness."""
    import jax
    from jax.sharding import Mesh
    from sanm_tpu.solver.linear import DeviceCholSolver

    body, _ = make_problem()
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    gin0 = model.lt_inp.remap.apply(jnp.asarray(model.x0()))
    J = batched_jacobian(model.fn, gin0)
    asm = SparseAssembler(
        model.lt_out.remap, model.lt_inp.remap, gin0.shape[0], 9, 9,
        model.lt_inp.n_unknown_vtx,
    )
    data, _ = asm.assemble_csr(J)

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("d",))
    s_single = DeviceCholSolver(asm, data, refine_steps=6)
    s_mesh = DeviceCholSolver(asm, data, refine_steps=6, mesh=mesh)
    assert s_single.factor_ok() and s_mesh.factor_ok()

    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-12):
        b = jnp.asarray(rng.standard_normal(asm.n) * scale)
        x_ref = np.asarray(s_single.solve(b))
        x_got = np.asarray(s_mesh.solve(b))
        np.testing.assert_allclose(x_got, x_ref, rtol=1e-8, atol=1e-30)
        resid = np.linalg.norm(
            np.asarray(asm.matvec(data, jnp.asarray(x_got))) - np.asarray(b)
        ) / (np.linalg.norm(np.asarray(b)) + 1e-300)
        assert resid < 1e-10, (scale, resid)


import pytest as _pytest


@_pytest.mark.parametrize("dev_mode", ["dense_chol", "band_chol"])
def test_implicit_solver_devloop(dev_mode):
    """The implicit driver's grad_t path through the fully
    device-resident devloop: f is chosen with a negative-definite
    Jacobian (the elastic convention dense_chol factors, A = -K), and
    ``_fact_dev`` confirms the devloop factored on-device rather than
    silently taking the indefinite-state host-LU fallback."""
    batch = 5
    rng = np.random.default_rng(2)
    x0 = rng.uniform(1.0, 2.0, batch)
    dx = rng.uniform(-2.0, -1.0, batch)
    rows = [[(i, 1.0), (batch, float(dx[i]))] for i in range(batch)]
    rin = LinearRemap(rows, batch + 1, (batch,))
    rout = LinearRemap.identity(batch)
    solver = ANMImplicitSolver(
        lambda x: -(x**1.5), rin, rout, x0, 0.0,
        HyperParam(solver=dev_mode),
    )
    it = 0
    while solver.get_t_upper() < 1.0:
        it += 1
        assert it < 20
        solver.update_approx()
    assert solver._fact_dev is not None, "devloop never factored"
    xt, t = solver.eval(solver.solve_a(1.0))
    require_tensor_eq(
        (np.asarray(xt) + dx) ** 1.5, x0**1.5, 1e-4,
        msg="implicit " + dev_mode,
    )


def test_host_splu_symmetric_and_fallback(monkeypatch):
    """``host_splu`` (the PARDISO-symmetric-mtype analog): the
    SymmetricMode fast path must hold full f64 accuracy on a healthy
    near-SPD system, fall back to COLAMD when its threshold pivots
    lose digits, and honor the ``SANM_SPLU_SYM=0`` opt-out."""
    import scipy.sparse as sp

    from sanm_tpu.solver.linear import host_splu

    rng = np.random.default_rng(5)
    n = 300
    A = sp.random(n, n, density=0.03, random_state=7)
    A = (A + A.T).tocsc() + sp.identity(n) * 8.0
    b = rng.standard_normal(n)
    x = host_splu(A).solve(b)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-12

    # near-singular diagonal: symmetric mode's 0.001-threshold pivots
    # degrade below the 1e-12 validation gate -> COLAMD fallback must
    # still deliver a usable solve
    B = (sp.random(n, n, density=0.03, random_state=8))
    B = (B + B.T).tocsc() + sp.diags(rng.standard_normal(n) * 1e-9)
    xb = host_splu(B).solve(b)
    assert np.isfinite(xb).all()
    assert np.linalg.norm(B @ xb - b) / np.linalg.norm(b) < 1e-8

    monkeypatch.setenv("SANM_SPLU_SYM", "0")
    x0 = host_splu(A).solve(b)
    assert np.linalg.norm(A @ x0 - b) / np.linalg.norm(b) < 1e-12


def test_devloop_numerical_fallback():
    """A devloop (band_chol/dense_chol) expansion that fails the
    order/orthogonality sanity checks must fall back to exact host LU
    for the rest of the solve instead of raising — the production
    safety net behind auto's band dispatch (measured trigger: jet NHI
    gravity, where the f32 band factor violates orthogonality at
    1.8e-2 while host LU solves the same system)."""
    body, f_load = make_problem()
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    f_sub = model.lt_inp.copy_vtx_values(f_load)
    hp = EqnHyperParam(order=8, solver="band_chol", loop="hybrid")
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    s = ANMEqnSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
        f_sub, hp,
    )
    orig = s._expand_hybrid_devloop
    calls = {"n": 0}

    def corrupting(xt0_np, v_np):
        calls["n"] += 1
        out = orig(xt0_np, v_np)
        if out is None:
            return None
        coeffs, diag = out
        bad = coeffs.copy()
        bad[2:] += 7.0  # breaks orthogonality against x1
        return bad, diag

    s._expand_hybrid_devloop = corrupting
    got = np.asarray(run_anm_eqn(s, progress=False))
    assert calls["n"] == 1, "fallback must be sticky (devloop not retried)"
    assert s._solver_override == "host_lu"
    assert s._solver_mode() == "host_lu"

    ref_hp = EqnHyperParam(order=8, solver="host_lu", loop="hybrid")
    ref_hp.converge_rms = RMS_THRESH_FORCE_EQU
    s2 = ANMEqnSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
        f_sub, ref_hp,
    )
    ref = np.asarray(run_anm_eqn(s2, progress=False))
    require_tensor_eq(got, ref, 1e-7, msg="fallback vs host_lu")
