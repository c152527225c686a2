"""Polynomial-matrix determinant coefficients.

Library-completeness counterpart of reference
``libsanm/tensor_polymat.cpp`` (``compute_polymat_det_coeff``,
``libsanm/tensor.h:498-506``): the coefficient of a^order in
det(sum_i A_i a^i) for batched square matrix series.

The FEA application never needs this directly — determinants there are
3x3 Leibniz compositions whose Taylor coefficients propagate through the
engine.  It is exposed for parity with the reference library API:

* m <= 4 uses the permutation expansion with series convolution
  (reference ``tensor_polymat.cpp:201-341``);
* larger m runs Faddeev-LeVerrier / Newton's identities over the
  truncated power-series ring: power sums p_j = tr(X(a)^j) as series,
  then e_k = (1/k) sum_j (-1)^{j-1} e_{k-j} p_j with det = e_m.  The
  reference instead evaluates at complex roots of unity and
  inverse-DFTs (``tensor_polymat.cpp:30-136``); the series-ring
  formulation avoids complex arithmetic altogether: all real f64,
  batched matmuls, exact for polynomials (no interpolation
  conditioning).
"""

from __future__ import annotations

import itertools
import math

import jax.numpy as jnp
import numpy as np

from ..utils import SANMError


def _perm_sign(perm):
    sign = 1
    seen = [False] * len(perm)
    for i in range(len(perm)):
        if seen[i]:
            continue
        j = i
        clen = 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


def _series_product_coeff(series_list, order):
    """Coefficient of a^order in the product of scalar series.

    Each element of ``series_list`` is a list of (B,) arrays (may be
    shorter than order+1; missing = 0)."""
    # fold pairwise, truncating at `order`
    cur = series_list[0][: order + 1]
    for nxt in series_list[1:]:
        nxt = nxt[: order + 1]
        out = [None] * (order + 1)
        for i, ci in enumerate(cur):
            if ci is None:
                continue
            for j, nj in enumerate(nxt):
                if nj is None or i + j > order:
                    continue
                t = ci * nj
                out[i + j] = t if out[i + j] is None else out[i + j] + t
        cur = out
    c = cur[order] if order < len(cur) else None
    return c


def polymat_det_coeff(mats, order: int):
    """Coefficient of a^order in det(sum_i mats[i] * a^i).

    ``mats``: sequence of (B, m, m) arrays.  Returns (B,) array."""
    mats = [jnp.asarray(m) for m in mats]
    B, m, m2 = mats[0].shape
    if m != m2:
        raise SANMError("polymat_det_coeff: square matrices required")
    L = len(mats)

    if m <= 4:
        total = None
        for perm in itertools.permutations(range(m)):
            sign = _perm_sign(perm)
            series_list = [
                [mats[t][:, i, perm[i]] for t in range(L)] for i in range(m)
            ]
            c = _series_product_coeff(series_list, order)
            if c is None:
                continue
            total = sign * c if total is None else total + sign * c
        if total is None:
            total = jnp.zeros((B,), mats[0].dtype)
        return total

    # m > 4: Faddeev-LeVerrier over the truncated series ring.  All
    # coefficients beyond `order` are irrelevant to the answer, so every
    # series is truncated at K = order.
    K = order
    dtype = mats[0].dtype
    zero = jnp.zeros((B, m, m), dtype)
    X = [mats[i] if i < L else zero for i in range(K + 1)]  # (K+1)(B,m,m)

    def smm(A, C):
        """Series matmul, truncated at order K."""
        return [
            sum(
                jnp.einsum(
                    "bij,bjk->bik", A[i], C[k - i], precision="highest"
                )
                for i in range(k + 1)
            )
            for k in range(K + 1)
        ]

    def sconv(a, c):
        """Series product of scalar series (lists of (B,))."""
        return [
            sum(a[i] * c[k - i] for i in range(k + 1))
            for k in range(K + 1)
        ]

    # power sums p_j = tr(X^j) as series, j = 1..m
    p = []
    cur = X
    for j in range(1, m + 1):
        if j > 1:
            cur = smm(cur, X)
        p.append(
            [jnp.trace(c, axis1=-2, axis2=-1) for c in cur]
        )
    # Newton's identities: e_0 = 1; e_k = (1/k) sum_{j<=k} (-1)^{j-1}
    # e_{k-j} p_j; det = e_m
    one = [jnp.ones((B,), dtype)] + [jnp.zeros((B,), dtype)] * K
    e = [one]
    for kk in range(1, m + 1):
        acc = None
        for j in range(1, kk + 1):
            t = sconv(e[kk - j], p[j - 1])
            sgn = 1.0 if j % 2 == 1 else -1.0
            acc = (
                [sgn * ti for ti in t]
                if acc is None
                else [ai + sgn * ti for ai, ti in zip(acc, t)]
            )
        e.append([ai / kk for ai in acc])
    return e[m][order]
