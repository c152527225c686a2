"""Mixed-precision order loop: f32 graph passes for orders >= 2 must
still drive the error-correcting continuation to the f64 residual
target (reference convergence target force-RMS 1e-10, fea/main.cpp:28).

``HyperParam.graph_dtype="f32"`` runs the high-order Taylor passes in
f32 while the Jacobian, the factorization, and all residual evaluations
stay f64 — the per-restart residual re-targeting absorbs the
coefficient noise.
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
from sanm_tpu.fea.app import run_anm_eqn
from sanm_tpu.solver import ANMEqnSolver
from sanm_tpu.solver.anm import EqnHyperParam
from sanm_tpu.taylor import TaylorFn, cast_taylor_fn

MATERIAL = MaterialProperty.from_young_poisson(1e7, 0.45)


def _problem():
    mesh = TetrahedralMesh.make_cuboid(4, 3, 3, 0.025)
    body = DeformableBody(MATERIAL, mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    f[mesh.vertices[:, 0] > 0.05, 2] = -30.0
    return body, f


def test_cast_taylor_fn_f32():
    """The f32 retrace evaluates the same function at f32 dtype/accuracy."""
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.standard_normal((5, 3, 3)))

    def fn(x):
        y = jnp.einsum("bij,bjk->bik", x, c)
        return jnp.log(jnp.sum(y * y, axis=(1, 2)) + 3.0) ** 2

    x = jnp.asarray(rng.standard_normal((5, 3, 3)))
    tfn = TaylorFn(fn, x)
    tfn32 = cast_taylor_fn(tfn, jnp.float32)
    out64 = np.asarray(tfn(x))
    out32 = np.asarray(tfn32(x.astype(jnp.float32)))
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, out64, rtol=2e-5)


@pytest.mark.parametrize(
    "em", [EnergyModel.NEOHOOKEAN_C, EnergyModel.ARAP]
)
@pytest.mark.slow
def test_hybrid_f32_converges(em):
    """f32 high-order passes (incl. the SVD-W scan rule for ARAP) reach
    the same 1e-10 residual target; iteration count stays comparable."""
    body, f = _problem()
    iters = {}
    for gd in ("f64", "f32"):
        model = body.make_forward(em)
        fl = model.lt_inp.copy_vtx_values(f)
        hp = EqnHyperParam(
            order=8, use_pade=True, loop="hybrid", solver="host_lu",
            graph_dtype=gd,
        )
        hp.converge_rms = 1e-10
        s = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
            fl, hp,
        )
        x = np.asarray(run_anm_eqn(s, progress=False))
        assert s.converged(), f"{em} graph_dtype={gd} did not converge"
        assert s.residual_rms() < 1e-10
        iters[gd] = s.get_nr_iter()
        if gd == "f64":
            x64 = x
        else:
            # solutions agree to the continuation tolerance
            np.testing.assert_allclose(x, x64, atol=1e-8)
    assert iters["f32"] <= iters["f64"] + 2, iters
