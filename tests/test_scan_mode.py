"""Scan-mode order loop (taylor_scan) must reproduce the unrolled
engine exactly — one lax.scan body replaces O(order) traced orders
(compile time independent of the order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sanm_tpu.fea import (
    DeformableBody,
    EnergyModel,
    MaterialProperty,
    TetrahedralMesh,
)
from sanm_tpu.fea.app import run_anm_eqn
from sanm_tpu.solver import ANMEqnSolver, ANMImplicitSolver, LinearRemap
from sanm_tpu.solver.anm import EqnHyperParam, HyperParam
from helper import require_tensor_eq

MATERIAL = MaterialProperty.from_young_poisson(1e7, 0.45)


def _problem():
    mesh = TetrahedralMesh.make_cuboid(4, 3, 3, 0.025)
    body = DeformableBody(MATERIAL, mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    f[mesh.vertices[:, 0] > 0.05, 2] = -30.0
    return body, f


@pytest.mark.parametrize(
    "em",
    [EnergyModel.NEOHOOKEAN_C, EnergyModel.NEOHOOKEAN_I, EnergyModel.ARAP],
)
@pytest.mark.slow
def test_scan_matches_unroll(em):
    body, f = _problem()
    sols = {}
    for loop in ("unroll", "scan", "hybrid"):
        model = body.make_forward(em)
        fl = model.lt_inp.copy_vtx_values(f)
        hp = EqnHyperParam(order=8, use_pade=True, loop=loop)
        hp.converge_rms = 1e-10
        s = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
            fl, hp,
        )
        sols[loop] = np.asarray(run_anm_eqn(s, progress=False))
    require_tensor_eq(
        sols["scan"], sols["unroll"], 1e-10, msg=f"scan vs unroll {em}"
    )
    require_tensor_eq(
        sols["hybrid"], sols["unroll"], 1e-10, msg=f"hybrid vs unroll {em}"
    )


def test_two_level_matches_single_level():
    """The two-level order loop (half-capacity step for k <= N/2, carry
    promoted at the boundary; anm._two_level_split) must reproduce the
    single-level hybrid loop exactly.  Forced on via SANM_TWO_LEVEL=1 so
    a non-svd graph takes the staged path too; exercises both the
    host-LU hybrid loop and the dense_chol devloop."""
    import os

    body, f = _problem()
    sols = {}
    for name, env, solver in (
        ("base", "0", "host_lu"),
        ("two_level", "1", "host_lu"),
        ("two_level_dev", "1", "dense_chol"),
    ):
        os.environ["SANM_TWO_LEVEL"] = env
        try:
            model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
            fl = model.lt_inp.copy_vtx_values(f)
            hp = EqnHyperParam(
                order=9, use_pade=True, loop="hybrid", solver=solver
            )
            hp.converge_rms = 1e-10
            s = ANMEqnSolver(
                model.fn, model.lt_inp.remap, model.lt_out.remap,
                model.x0(), fl, hp,
            )
            if env == "1":
                assert s._two_level_split(s.tfn) == 4
            sols[name] = np.asarray(run_anm_eqn(s, progress=False))
        finally:
            del os.environ["SANM_TWO_LEVEL"]
    require_tensor_eq(
        sols["two_level"], sols["base"], 1e-10, msg="two-level hybrid"
    )
    require_tensor_eq(
        sols["two_level_dev"], sols["base"], 1e-8,
        msg="two-level dense_chol devloop",
    )


def test_scan_implicit_solver():
    # implicit continuation (grad_t path) under scan, incl. pow chain
    batch = 5
    rng = np.random.default_rng(3)
    x0 = rng.uniform(1.0, 2.0, batch)
    dx = rng.uniform(-2.0, -1.0, batch)
    rows = [[(i, 1.0), (batch, float(dx[i]))] for i in range(batch)]
    rin = LinearRemap(rows, batch + 1, (batch,))
    rout = LinearRemap.identity(batch)

    def f(x):
        return x**1.5 + 0.1 * x**3

    sols = {}
    for loop in ("unroll", "scan"):
        solver = ANMImplicitSolver(
            f, rin, rout, x0, 0.0, HyperParam(order=8, loop=loop)
        )
        it = 0
        while solver.get_t_upper() < 1.0:
            it += 1
            assert it < 30
            solver.update_approx()
        sols[loop] = np.asarray(solver.eval(solver.solve_a(1.0))[0])
    require_tensor_eq(
        sols["scan"], sols["unroll"], 1e-8, msg="scan vs unroll implicit"
    )
