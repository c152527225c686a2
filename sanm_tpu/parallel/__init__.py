"""Multi-device SPMD scaling.

The reference scales by sharding the element batch across OS threads,
each owning a replica of the whole graph (``ParallelTaylorCoeffProp``,
``libsanm/symbolic.cpp:305-591``) with mutex/condvar gathers.  Under
XLA that entire machinery collapses into data sharding: every (B, ...)
element-batched array is sharded over the ``elems`` axis of a
``jax.sharding.Mesh``, XLA inserts the ``all_gather``/``psum``
collectives over the device interconnect for the remap gathers and the ANM scalar
reductions, and the factorized linear solve stays replicated (it is the
one global synchronization point, as PARDISO is in the reference).
"""

from .mesh import ElemSharding  # noqa: F401
