"""Deformable body: assembling the elastic force model.

Counterpart of reference ``DeformableBody`` (``fea/mesh_template.h:163-237``):

* forward model — unknowns are the deformed free vertex coordinates;
  the graph maps remapped shape matrices ``Ds`` to the first
  Piola-Kirchhoff stress ``P(F)`` with ``F = Ds Dm^{-1}``; the output
  remap (rest-shape normals) turns P into nodal forces;
* inverse model — unknowns are the *rest* coordinates; the graph maps
  remapped rest shape matrices ``Dm`` to the Cauchy stress
  ``sigma(F)`` with ``F = Ds Dm^{-1}`` (Ds of the known deformed mesh);
  the output remap uses the deformed mesh's normals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..ops import batched_inv
from ..utils import SANMError, sanm_assert
from .material import (
    EnergyModel,
    MaterialProperty,
    cauchy_stress,
    elastic_potential_density,
    pk1,
)
from .mesh import TetrahedralMesh
from .remap import ForceOutputRemap, ShapeMatRemap


@dataclass
class ElasticForceModel:
    """Reference ``DeformableBody::ElasticForceModel``
    (``fea/mesh_template.h:153-159``)."""

    fn: Callable  # (T,3,3) remapped input -> (T,3,3) stress
    lt_inp: ShapeMatRemap
    lt_out: ForceOutputRemap
    potential_fn: Optional[Callable] = None  # (T,3,3) input -> (T,) energy

    def x0(self):
        return self.lt_inp.x0

    def eval_force(self, x):
        """Plain force evaluation at unknown vector x (no Taylor),
        cf. reference ``compute_force_rms`` inner evaluation.

        Evaluated in strict-IEEE NumPy f64, independent of any backend's
        compile flags: this is the residual reported against the 1e-10
        verification target."""
        if getattr(self, "_np_eval", None) is None:
            from ..taylor import TaylorFn, numpy_eval

            gshape = self.lt_inp.remap.out_shape
            import jax as _jax

            tfn = TaylorFn(
                self.fn, _jax.ShapeDtypeStruct(gshape, jnp.float64)
            )
            object.__setattr__(self, "_np_eval", numpy_eval(tfn))
        g = self.lt_inp.remap.apply_np(np.asarray(x))
        return self.lt_out.remap.apply_np(self._np_eval(g))

    def eval_potential(self, x):
        if self.potential_fn is None:
            return None
        g = self.lt_inp.remap.apply(jnp.asarray(x).reshape(-1))
        return jnp.sum(self.potential_fn(g))


def _has_potential(em, material) -> bool:
    """Abstractly probe whether the energy model provides a potential
    density (no device computation)."""
    import jax

    found = []

    def probe(F):
        r = elastic_potential_density(em, material, F, 3)
        found.append(r is not None)
        return jnp.zeros(()) if r is None else r

    jax.eval_shape(probe, jax.ShapeDtypeStruct((1, 3, 3), jnp.float64))
    return found[0]


class DeformableBody:
    """Reference ``DeformableBody<3, TetrahedralMesh>``."""

    def __init__(self, material: MaterialProperty, mesh: TetrahedralMesh):
        self.material = material
        self.mesh = mesh
        self.coord_fixed_mask = np.zeros((mesh.nr_vertices, 3), bool)

    # ------------------------------------------------------------------
    def make_forward(
        self,
        energy_model: EnergyModel,
        init_vtx_coord=None,
        vtx_delta=None,
    ) -> ElasticForceModel:
        """Forward model (reference ``make_forward``,
        ``fea/mesh_template.h:191-219``)."""
        lt_inp = ShapeMatRemap(
            self.mesh, self.coord_fixed_mask, init_vtx_coord, vtx_delta
        )
        lt_out = ForceOutputRemap(lt_inp)
        bias = jnp.asarray(lt_inp.bias)
        # host-side inverse: avoids eager device kernels at build time
        dm_inv = jnp.asarray(np.linalg.inv(self.mesh.shape_matrix))
        material = self.material
        em = energy_model

        def fn(g):
            ds = g + bias
            F = jnp.einsum("bij,bjk->bik", ds, dm_inv, precision="highest")
            return pk1(em, material, F, 3)

        pot = None
        if _has_potential(em, material):
            vols = jnp.asarray(self.mesh.tet_volumes)

            def pot(g):
                ds = g + bias
                F = jnp.einsum("bij,bjk->bik", ds, dm_inv, precision="highest")
                return (
                    elastic_potential_density(em, material, F, 3) * vols
                )

        return ElasticForceModel(fn, lt_inp, lt_out, pot)

    # ------------------------------------------------------------------
    def make_inverse(self, energy_model: EnergyModel) -> ElasticForceModel:
        """Inverse (rest-shape design) model (reference ``make_inverse``,
        ``fea/mesh_template.h:172-189``)."""
        lt_inp = ShapeMatRemap(self.mesh, self.coord_fixed_mask, None, None)
        lt_out = ForceOutputRemap(lt_inp)
        bias = jnp.asarray(lt_inp.bias)
        ds_const = jnp.asarray(self.mesh.shape_matrix)
        material = self.material
        em = energy_model

        def fn(g):
            dm = g + bias
            # F = Ds @ Dm^{-1}
            F = jnp.einsum(
                "bij,bjk->bik", ds_const, batched_inv(dm),
                precision="highest",
            )
            return cauchy_stress(em, material, F, 3)

        return ElasticForceModel(fn, lt_inp, lt_out, None)

    # ------------------------------------------------------------------
    @staticmethod
    def compute_force_rms(
        model: ElasticForceModel, xt, f_load, final_mesh=None,
        sanity_check=False,
    ) -> float:
        """Recompute the force residual RMS at a solution (reference
        ``compute_force_rms``, ``fea/mesh_template.h:221-237``)."""
        force = np.asarray(model.eval_force(xt))
        f_load = np.asarray(f_load).reshape(-1)
        if sanity_check:
            scale = np.maximum(np.abs(force), 1.0)
            if np.max(np.abs(force + f_load) / scale) > 1e-5:
                raise SANMError("force equilibrium check failed")
        r = force + f_load
        return float(np.sqrt(np.mean(r * r)))
