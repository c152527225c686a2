"""sanm_tpu — a JAX Symbolic Asymptotic Numerical Method framework.

A from-scratch JAX/XLA re-design of the capabilities of jia-kai/SANM
(SIGGRAPH 2021, arXiv:2105.08535).  The reference implementation is a
C++20/MKL thread-parallel CPU solver; this package maps the same
algorithms onto an accelerator through XLA:

* the symbolic computing graph + hand-written per-operator Taylor
  recurrences (reference ``libsanm/symbolic.{h,cpp}``, ``libsanm/oprs/*``)
  become a jaxpr-interpreting Taylor-coefficient engine
  (:mod:`sanm_tpu.taylor`) — models are written as plain ``jax.numpy``
  functions and the order-k coefficient rules compose automatically;
* the thread data-parallel batch engine (reference
  ``ParallelTaylorCoeffProp``, ``libsanm/symbolic.cpp:305-591``)
  disappears: element batches are jitted SPMD arrays, sharded over a
  ``jax.sharding.Mesh`` axis for multi-device scaling
  (:mod:`sanm_tpu.parallel`);
* the MKL PARDISO factorize-once / back-substitute-per-order sparse
  solver (reference ``libsanm/sparse_solver.cpp``) is replaced by
  host sparse LU and device factorizations that preserve the same
  factorize-once/N-solve structure (:mod:`sanm_tpu.solver.linear`);
* the FEA application (reference ``fea/``) is rebuilt on batched
  per-tetrahedron tensors (:mod:`sanm_tpu.fea`).

The solver core runs in float64 because the ANM order-20 expansions and
the 1e-10 force-RMS convergence targets of the reference are
double-precision territory (reference
``libsanm/unary_polynomial.cpp:97-103``, ``fea/main.cpp:28``).
Correctness-critical dots request ``precision="highest"`` explicitly,
and the float32 factorization routes of :mod:`sanm_tpu.solver.linear`
and :mod:`sanm_tpu.solver.band` set their own precision: no dot that
matters inherits the backend's default (TF32 on recent NVIDIA GPUs).
"""

import os as _os

import jax as _jax

# The whole framework assumes x64 (reference fp_t = double,
# libsanm/typedefs.h:12).  Must happen before any array is created.
_jax.config.update("jax_enable_x64", True)

#: persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path inside the checkout (listed in ``.gitignore``),
#: so every process of one checkout shares it and its key never moves
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    The expansion kernels are large programs, so the CLI and the bench
    entry points cache them across processes.  ``JAX_COMPILATION_CACHE_DIR``
    wins when set (no other directory is configured); otherwise the
    cache lives at :data:`DEFAULT_CACHE_DIR`.  Touches no backend.  Not
    enabled at import, so test runs stay uncached."""
    cache_dir = (
        _os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    )
    _os.makedirs(cache_dir, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir


from . import utils  # noqa: E402
from .utils import SANMError, SANMNumericalError, ScopedProfiler  # noqa: E402
from . import taylor  # noqa: E402
from . import ops  # noqa: E402

__version__ = "0.1.0"
