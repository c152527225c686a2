"""Element-axis sharding for ANM solves.

Replaces the reference thread data-parallel engine
(``ParallelTaylorCoeffProp``): the element batch dimension is sharded
over a 1-D device mesh axis ``elems``.  All per-element work (Taylor
graph passes, per-element Jacobians, element-stiffness contraction)
runs SPMD; the scatter-add assembly and the scalar reductions become
XLA collectives over the device interconnect; the dense factorization
runs replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class ElemSharding:
    """Callable sharding hook for the ANM drivers' ``shard_elems``.

    Applies ``with_sharding_constraint`` along axis 0 (the element
    batch) of batched arrays; scalars/vectors pass through replicated.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 axis_name: str = "elems"):
        if devices is None:
            devices = jax.devices()
        self.mesh = Mesh(np.asarray(devices), (axis_name,))
        self.axis_name = axis_name

    def __call__(self, x):
        if x is None:
            return None
        if x.ndim == 0:
            return x
        spec = P(self.axis_name, *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec)
        )

    def put(self, x):
        """Device-put a batched array sharded along elements."""
        spec = P(self.axis_name, *([None] * (np.ndim(x) - 1)))
        return jax.device_put(x, NamedSharding(self.mesh, spec))
