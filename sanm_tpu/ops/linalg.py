"""Batched small-matrix linear algebra as jnp compositions.

The reference implements these as atomic operators with hand-written
Taylor recurrences (``libsanm/oprs/linalg.cpp``, ``libsanm/tensor_linalg.cpp``).
Here they are closed-form compositions of +,*,/ — their order-k Taylor
coefficients then compose automatically in :mod:`sanm_tpu.taylor`, and
XLA fuses the elementwise graphs into a handful of kernels.  All
functions take ``(B, n, n)`` arrays with n in {1, 2, 3} (the FEA app only
uses n == dim == 2 or 3; the reference's generic-n paths via LU/FFT exist
for library completeness and are provided by :mod:`sanm_tpu.ops.polymat`).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax._src import core as jcore
from jax.extend.core import Primitive
from jax.interpreters import ad, mlir

from ..utils import SANMError


def batched_transpose(x):
    """(B, m, n) -> (B, n, m); reference ``libsanm/oprs/linalg.cpp`` batch_transpose."""
    return jnp.swapaxes(x, -1, -2)


def batched_det(x):
    """Batched determinant via the Leibniz expansion (n <= 3).

    Composes through the Taylor engine as pure multiply/add — the
    reference instead propagates polynomial-matrix determinant
    coefficients (``libsanm/tensor_polymat.cpp:201-341``, m<=4 Leibniz
    path); for n<=3 the direct expansion is equivalent and cheaper."""
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise SANMError("batched_det: not square")
    if n == 1:
        return x[..., 0, 0]
    if n == 2:
        return x[..., 0, 0] * x[..., 1, 1] - x[..., 0, 1] * x[..., 1, 0]
    if n == 3:
        return (
            x[..., 0, 0] * (x[..., 1, 1] * x[..., 2, 2] - x[..., 1, 2] * x[..., 2, 1])
            - x[..., 0, 1] * (x[..., 1, 0] * x[..., 2, 2] - x[..., 1, 2] * x[..., 2, 0])
            + x[..., 0, 2] * (x[..., 1, 0] * x[..., 2, 1] - x[..., 1, 1] * x[..., 2, 0])
        )
    # generic n: atomic primitive with the polymat-coefficient Taylor
    # rule (reference det tested to 7x7, tests/symbolic.cpp:324-360)
    return det_p.bind(x)


def batched_cofactor(x):
    """Cofactor matrix C with C[i,j] = d det(x) / d x[i,j]
    (so ``det(x) * inv(x) == C^T``).  Reference: SVD-free equivalent of
    ``TensorND::as_batched_cofactor`` (``libsanm/tensor_linalg.cpp:355-392``)."""
    n = x.shape[-1]
    if n == 1:
        return jnp.ones_like(x)
    if n == 2:
        a, b = x[..., 0, 0], x[..., 0, 1]
        c, d = x[..., 1, 0], x[..., 1, 1]
        return jnp.stack(
            [
                jnp.stack([d, -c], axis=-1),
                jnp.stack([-b, a], axis=-1),
            ],
            axis=-2,
        )
    if n == 3:
        def minor(i, j):
            rows = [r for r in range(3) if r != i]
            cols = [c for c in range(3) if c != j]
            return (
                x[..., rows[0], cols[0]] * x[..., rows[1], cols[1]]
                - x[..., rows[0], cols[1]] * x[..., rows[1], cols[0]]
            )

        entries = [
            [minor(i, j) * ((-1.0) ** (i + j)) for j in range(3)]
            for i in range(3)
        ]
        return jnp.stack(
            [jnp.stack(row, axis=-1) for row in entries], axis=-2
        )
    return batched_cofactor_nd(x)


def batched_inv(x):
    """Batched inverse via adjugate / determinant (n <= 3).

    Replaces the reference's ``batched_mat_inv_mul`` operator whose
    order-k recurrence is ``y_k = x0^-1 (a_k - sum x_i y_{k-i})``
    (``libsanm/oprs/linalg.cpp:146-197``); as adj/det it composes through
    the generic mul/div Taylor rules.  For n > 3 an atomic primitive
    carries exactly that recurrence (with a = I; compose with matmul for
    the general inv_mul forms)."""
    if x.shape[-1] > 3:
        return matinv_p.bind(x)
    det = batched_det(x)
    adj = batched_transpose(batched_cofactor(x))
    return adj / det[..., None, None]


def batched_mul_eye(s, dim):
    """Batched scalar -> scalar * I_dim (reference batch_mul_eye,
    ``libsanm/oprs/linalg.h:15-247``).  ``s`` has shape (B,) or (B,1)."""
    s = s.reshape(s.shape[0])
    return s[:, None, None] * jnp.eye(dim, dtype=s.dtype)


# ----------------------------------------------------------------------------
# generic-n inverse / determinant / cofactor
#
# For n > 3 the closed-form compositions above do not exist; the
# reference handles any n with atomic operators carrying hand-written
# Taylor recurrences (matinv: ``libsanm/oprs/linalg.cpp:146-197``; det
# via cofactor linearization + polynomial-matrix determinant
# coefficients: ``:250-273``, tested to 7x7 in
# ``tests/symbolic.cpp:324-360``).  Never reached by the FEA app (whose
# matrices are dim x dim <= 3x3) — library-completeness parity.
# ----------------------------------------------------------------------------


def _bmm(a, b):
    """Batched matmul at HIGHEST precision (Taylor coefficients cannot
    survive a backend's reduced-precision default f32 matmul passes)."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision="highest")


def batched_cofactor_nd(x):
    """Generic-n batched cofactor via SVD, rank-robust like the
    reference (``TensorND::as_batched_cofactor``,
    ``libsanm/tensor_linalg.cpp:355-392``): with x = U S V^T,
    cof(x) = det(U V^T) * U diag(prod_{j != i} s_j) V^T — each entry of
    the diagonal drops exactly one singular value, so a single zero
    singular value stays finite."""
    u, s, vh = jnp.linalg.svd(x)
    n = s.shape[-1]
    eye = jnp.eye(n, dtype=bool)
    p = jnp.prod(
        jnp.where(eye, jnp.ones_like(s)[..., None, :], s[..., None, :]),
        axis=-1,
    )
    sgn = batched_det_nd(_bmm(u, vh))
    return sgn[..., None, None] * _bmm(u * p[..., None, :], vh)


def batched_det_nd(x):
    return jnp.linalg.det(x)


matinv_p = Primitive("sanm_matinv")


@matinv_p.def_abstract_eval
def _matinv_abstract(x):
    assert x.shape[-1] == x.shape[-2], "matinv: square matrices required"
    return jcore.ShapedArray(x.shape, x.dtype)


matinv_p.def_impl(lambda x: jnp.linalg.inv(x))
mlir.register_lowering(
    matinv_p, mlir.lower_fun(lambda x: jnp.linalg.inv(x),
                             multiple_results=False)
)


def _matinv_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = matinv_p.bind(x)
    if isinstance(dx, ad.Zero):
        return y, ad.Zero.from_primal_value(y)
    return y, -_bmm(_bmm(y, dx), y)


ad.primitive_jvps[matinv_p] = _matinv_jvp


det_p = Primitive("sanm_det")


@det_p.def_abstract_eval
def _det_abstract(x):
    assert x.shape[-1] == x.shape[-2], "det: square matrices required"
    return jcore.ShapedArray(x.shape[:-2], x.dtype)


det_p.def_impl(lambda x: jnp.linalg.det(x))
mlir.register_lowering(
    det_p, mlir.lower_fun(lambda x: jnp.linalg.det(x),
                          multiple_results=False)
)


def _det_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    d = det_p.bind(x)
    if isinstance(dx, ad.Zero):
        return d, ad.Zero.from_primal_value(d)
    cof = batched_cofactor_nd(x)
    return d, jnp.sum(cof * dx, axis=(-2, -1))


ad.primitive_jvps[det_p] = _det_jvp


def _matinv_taylor_rule(engine, eqn, idx, k, in_k, cache, commit):
    """y = x^{-1}: from x @ y = I,
    y_k = -y0 (x_k y0 + sum_{0<i<k} x_i y_{k-i}) — the reference
    batched_mat_inv_mul recurrence with a = I
    (``libsanm/oprs/linalg.cpp:146-197``); affine in x_k as the engine
    requires (lin = -y0 x_k y0, bias = the convolution part)."""
    from ..taylor import z_add

    x = eqn.invars[0]
    y = eqn.outvars[0]
    x_k = in_k[0]
    y0 = engine.coeff0(y)
    if cache is None:
        terms = []
        if not engine._series_const(x):
            for i in range(1, k):
                xi = engine.coeff(x, i)
                yki = engine.coeff(y, k - i)
                if xi is not None and yki is not None:
                    terms.append(_bmm(xi, yki))
        s = z_add(*terms)
        cache = None if s is None else -_bmm(y0, s)
    lin = None if x_k is None else -_bmm(_bmm(y0, x_k), y0)
    return [z_add(lin, cache)], cache


def _det_taylor_rule(engine, eqn, idx, k, in_k, cache, commit):
    """d = det(x): order-k coefficient splits into the x_k-free part —
    the order-k polynomial-matrix determinant coefficient of the
    truncated series x_0..x_{k-1} — plus the linearization
    sum_ij cof(x0)_ij (x_k)_ij (reference BatchedDeterminant,
    ``libsanm/oprs/linalg.cpp:250-273``)."""
    from ..taylor import materialize, z_add
    from .polymat import polymat_det_coeff

    x = eqn.invars[0]
    x_k = in_k[0]
    if cache is None and not engine._series_const(x):
        mats = [
            materialize(engine.coeff(x, i), x.aval) for i in range(k)
        ]
        cache = polymat_det_coeff(mats, k)
    cof = engine.userdata.get(idx)
    if cof is None:
        cof = batched_cofactor_nd(engine.coeff0(x))
        engine.userdata[idx] = cof
    lin = None if x_k is None else jnp.sum(cof * x_k, axis=(-2, -1))
    return [z_add(lin, cache)], cache


def _register_taylor_rules():
    from .. import taylor

    taylor.register_rule(
        matinv_p,
        _matinv_taylor_rule,
        lambda eqn, vy: ([True], [vy(eqn.invars[0])]),
    )
    taylor.register_rule(
        det_p,
        _det_taylor_rule,
        lambda eqn, vy: ([True], [False]),
    )


_register_taylor_rules()
