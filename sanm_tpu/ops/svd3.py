"""Batched small-matrix SVD via vectorized one-sided Jacobi.

Replacement for LAPACK-style SVD on (B, 2, 2) and (B, 3, 3)
batches: XLA's generic ``jnp.linalg.svd`` lowers to a sequential
QR-iteration loop per matrix, while the FEA workloads need the SVD of
every element's deformation gradient (the reference runs Eigen's
JacobiSVD in a per-tet loop, ``libsanm/tensor_svd.cpp:63-131``).  Here
all matrices rotate in lockstep: a fixed number of cyclic one-sided
Jacobi sweeps, each a handful of (B,)-wide elementwise ops — no data-dependent
control flow, fully fusible, shardable over the batch.

One-sided Jacobi works on the columns of A = M V directly (not on
M^T M), so small singular values keep full relative accuracy.  Sorted
descending to match ``jnp.linalg.svd`` conventions.
"""

from __future__ import annotations

import jax.numpy as jnp

N_SWEEPS = 12  # quadratic convergence; 3x3 reaches f64 limits in ~6


def _rotate_pair(A, V, p, q):
    """One Jacobi rotation orthogonalizing columns p, q of every A."""
    ap = A[:, :, p]
    aq = A[:, :, q]
    app = jnp.sum(ap * ap, axis=1)
    aqq = jnp.sum(aq * aq, axis=1)
    apq = jnp.sum(ap * aq, axis=1)

    # rotation angle zeroing the (p,q) Gram entry.  Overflow-free form:
    # the classical tau = (aqq-app)/(2*apq) overflows for tiny apq, and
    # downstream arithmetic turns that overflow into NaN (inf - inf; a
    # few rest-state elements of a real mesh NaN'd the ARAP Jacobian
    # this way).  Using
    #   t = 2*apq*sign(d) / (|d| + sqrt(d^2 + 4*apq^2)),   d = aqq - app
    # never divides by apq; the denominator is >= |d| and the arguments
    # stay at the scale of the Gram entries.
    d = aqq - app
    den = jnp.abs(d) + jnp.sqrt(d * d + 4.0 * apq * apq)
    sign_d = jnp.where(d < 0, -1.0, 1.0)
    t = 2.0 * apq * sign_d / jnp.where(den == 0, 1.0, den)
    # skip (identity rotation) when already orthogonal enough: relative
    # threshold keeps tiny columns stable
    tiny = jnp.abs(apq) <= 1e-300 + 0.0 * app
    t = jnp.where(tiny, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c

    cb = c[:, None]
    sb = s[:, None]
    ap_new = cb * ap - sb * aq
    aq_new = sb * ap + cb * aq
    A = A.at[:, :, p].set(ap_new).at[:, :, q].set(aq_new)
    vp = V[:, :, p]
    vq = V[:, :, q]
    V = V.at[:, :, p].set(cb * vp - sb * vq).at[
        :, :, q
    ].set(sb * vp + cb * vq)
    return A, V


def svd_batched_small(m):
    """SVD of (B, n, n) with n in {2, 3}: returns (u, s, vh) with
    singular values sorted descending, m = u @ diag(s) @ vh."""
    B, n, n2 = m.shape
    assert n == n2 and n in (2, 3)
    dtype = m.dtype
    A = m
    V = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (B, n, n))
    pairs = [(0, 1)] if n == 2 else [(0, 1), (0, 2), (1, 2)]
    for _ in range(N_SWEEPS):
        for (p, q) in pairs:
            A, V = _rotate_pair(A, V, p, q)

    s = jnp.sqrt(jnp.sum(A * A, axis=1))  # column norms (B, n)
    # sort descending
    order = jnp.argsort(-s, axis=1)
    s = jnp.take_along_axis(s, order, axis=1)
    A = jnp.take_along_axis(A, order[:, None, :], axis=2)
    V = jnp.take_along_axis(V, order[:, None, :], axis=2)

    # normalize columns of A into U; repair near-null columns
    eps_rel = 1e-300
    u = A / jnp.where(s[:, None, :] > eps_rel, s[:, None, :], 1.0)
    if n == 3:
        # if the smallest singular value is ~0, rebuild u[:, :, 2] as the
        # cross product of the first two columns (keeps U orthogonal)
        cross = jnp.cross(u[:, :, 0], u[:, :, 1], axis=1)
        cn = jnp.linalg.norm(cross, axis=1, keepdims=True)
        cross = cross / jnp.where(cn > 0, cn, 1.0)
        bad = (s[:, 2] <= 1e-15 * s[:, 0])[:, None]
        u = u.at[:, :, 2].set(jnp.where(bad, cross, u[:, :, 2]))
    else:
        rot = jnp.stack([-u[:, 1, 0], u[:, 0, 0]], axis=1)
        bad = (s[:, 1] <= 1e-15 * s[:, 0])[:, None]
        u = u.at[:, :, 1].set(jnp.where(bad, rot, u[:, :, 1]))

    vh = jnp.swapaxes(V, -1, -2)
    return u, s, vh
