"""SVD-W: the decomposition M = U S U^T W with orthogonal U, W.

This is the one genuinely non-composable operator of the framework (the
reference devotes ``libsanm/tensor_svd.cpp`` + the SVDW operator in
``libsanm/oprs/linalg.cpp:516-603`` to it).  Writing M = U S V^T for the
ordinary SVD, we have W = U V^T — the rotation factor of the polar
decomposition M = P W with P = U S U^T symmetric.

Three pieces live here:

* :func:`svd_w` — a JAX primitive evaluating the batched decomposition,
  including the ``require_rotation`` sign-flip policy that negates a
  well-chosen group of singular values so that det(W) = +1 (reference
  ``TensorND::compute_batched_svd_w``, ``libsanm/tensor_svd.cpp:48-145``);
* an analytic JVP rule (the order-1 specialization of the Taylor
  recurrence; equivalent to the reference reverse-mode
  ``svd_w_grad_revmode``, ``libsanm/tensor_svd.cpp:147-273``, but in
  forward form since Jacobians are assembled by forward propagation
  here);
* the order-k Taylor rules in both modes, re-derived from the defining
  equations (see docstrings below) and verified to match the reference
  ``svd_w_taylor_fwd`` (USU^TW mode, ``libsanm/tensor_svd.cpp:275-387``)
  and ``svd_w_taylor_fwd_p`` (polar P·W mode used when U, S have no
  readers, ``libsanm/tensor_svd.cpp:389-475``; mode auto-detection
  mirrors ``libsanm/oprs/linalg.cpp:529-541``).

Degenerate spectra are handled with the reference's Tikhonov-regularized
division ``clip_div(x, y) = x*y/(y^2 + 1e-12)``
(``libsanm/tensor_svd.cpp:28-31``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax._src import core as jcore
from jax.extend.core import Primitive
from jax.interpreters import ad, mlir

from .. import taylor
from ..taylor import materialize, z_add
from .linalg import batched_det

CLIP_EPS = 1e-12
GROUP_EPS = 1e-3  # singular values closer than this are one group
                  # (reference libsanm/tensor_svd.cpp:92)


def clip_div(x, y):
    return x * y / (y * y + CLIP_EPS)


# ----------------------------------------------------------------------------
# primal evaluation
# ----------------------------------------------------------------------------


def _svd_w_eval(m, require_rotation: bool):
    """Batched (B,n,n) SVD-W.  Returns (u, s, w)."""
    if m.shape[-1] in (2, 3):
        # vectorized one-sided Jacobi: every element rotates in lockstep
        # (elementwise work XLA fuses), instead of the generic batched
        # QR-iteration SVD
        from .svd3 import svd_batched_small

        u, s, vh = svd_batched_small(m)
    else:
        u, s, vh = jnp.linalg.svd(m)
    if require_rotation:
        # flip a group of singular values (and the matching U columns) so
        # that det(U) * det(V) = +1, hence det(W) = +1.  Group selection
        # follows libsanm/tensor_svd.cpp:88-127: prefer the group of
        # smallest values with the least repetitions; negate the whole
        # group when its size is odd (keeps s_i + s_j != 0 inside the
        # group), otherwise a single member.
        n = m.shape[-1]
        B = m.shape[0]
        need = batched_det(u) * batched_det(jnp.swapaxes(vh, -1, -2)) < 0

        # group starts & sizes over the descending-sorted s
        is_start = [None] * n
        is_start[0] = jnp.ones((B,), bool)
        for i in range(1, n):
            is_start[i] = (s[:, i - 1] - s[:, i]) >= GROUP_EPS
        # size of the group starting at i (0 if not a start)
        sizes = []
        for i in range(n):
            nr = jnp.ones((B,), jnp.int32)
            alive = jnp.ones((B,), bool)
            for j in range(i + 1, n):
                alive = alive & ~is_start[j]
                nr = nr + alive.astype(jnp.int32)
            sizes.append(jnp.where(is_start[i], nr, 0))

        best_idx = jnp.zeros((B,), jnp.int32)
        best_nr = jnp.full((B,), n + 1, jnp.int32)
        for i in range(n):
            nr = sizes[i]
            cand = is_start[i] & (
                (nr <= best_nr) | ((nr == best_nr + 1) & (nr % 2 == 1))
            )
            best_idx = jnp.where(cand, i, best_idx)
            best_nr = jnp.where(cand, nr, best_nr)

        single = (best_nr == 1) | (best_nr % 2 == 0)
        idxs = jnp.arange(n)
        in_group = (idxs[None, :] >= best_idx[:, None]) & (
            idxs[None, :] < (best_idx + best_nr)[:, None]
        )
        flip_mask = jnp.where(
            single[:, None], idxs[None, :] == best_idx[:, None], in_group
        )
        sign = jnp.where(need[:, None] & flip_mask, -1.0, 1.0)
        s = s * sign
        u = u * sign[:, None, :]  # scale columns of U
    w = u @ vh
    return u, s, w


svd_w_p = Primitive("sanm_svd_w")
svd_w_p.multiple_results = True


@svd_w_p.def_abstract_eval
def _svd_w_abstract(m, *, require_rotation):
    B, n, n2 = m.shape
    assert n == n2, "svd_w: square matrices required"
    return (
        jcore.ShapedArray((B, n, n), m.dtype),
        jcore.ShapedArray((B, n), m.dtype),
        jcore.ShapedArray((B, n, n), m.dtype),
    )


def _svd_w_impl(m, *, require_rotation):
    return _svd_w_eval(m, require_rotation)


svd_w_p.def_impl(_svd_w_impl)
mlir.register_lowering(
    svd_w_p, mlir.lower_fun(_svd_w_impl, multiple_results=True)
)


def svd_w(m, require_rotation: bool = False):
    """Batched SVD-W of (B, n, n): (u, s, w) with m = u @ diag(s) @ u.T @ w.

    Public counterpart of ``SymbolVar::batched_svd_w``
    (``libsanm/oprs.h:57``)."""
    return tuple(svd_w_p.bind(m, require_rotation=bool(require_rotation)))


def polar_w(m, require_rotation: bool = True):
    """Rotation factor W of the polar decomposition m = P @ W.

    Leaving u, s unused lets the Taylor engine select the cheaper,
    degeneracy-robust polar propagation mode (reference pw_mode,
    ``libsanm/oprs/linalg.cpp:529-541``)."""
    return svd_w(m, require_rotation)[2]


# ----------------------------------------------------------------------------
# JVP (order-1 Taylor): with A = U^T dM V,
#   dS = diag(A)
#   dW = U X V^T,          X_ij = (A_ij - A_ji) / (s_i + s_j)
#   dU = U Omega,      Omega_ij = (s_j A_ij + s_i A_ji) / (s_j^2 - s_i^2)
# (equivalent to libsanm/tensor_svd.cpp:147-273 in forward form)
# ----------------------------------------------------------------------------


def _svd_w_jvp(primals, tangents, *, require_rotation):
    (m,) = primals
    (dm,) = tangents
    u, s, w = svd_w_p.bind(m, require_rotation=require_rotation)
    if isinstance(dm, ad.Zero):
        z3 = ad.Zero.from_primal_value
        return (u, s, w), (z3(u), z3(s), z3(w))
    v = jnp.swapaxes(w, -1, -2) @ u  # V = W^T U
    a = jnp.swapaxes(u, -1, -2) @ dm @ v
    at = jnp.swapaxes(a, -1, -2)
    ds = jnp.diagonal(a, axis1=-2, axis2=-1)
    sp = s[:, :, None] + s[:, None, :]
    sm2 = s[:, None, :] ** 2 - s[:, :, None] ** 2  # s_j^2 - s_i^2 at (i,j)
    x = clip_div(a - at, sp)
    dw = u @ x @ jnp.swapaxes(v, -1, -2)
    omega = clip_div(s[:, None, :] * a + s[:, :, None] * at, sm2)
    n = m.shape[-1]
    omega = omega * (1.0 - jnp.eye(n, dtype=m.dtype))
    du = u @ omega
    return (u, s, w), (du, ds, dw)


ad.primitive_jvps[svd_w_p] = _svd_w_jvp


# ----------------------------------------------------------------------------
# Taylor rules
# ----------------------------------------------------------------------------


def _use_vpu(a, b):
    """Whether an f64 matmul on (..., <=4, <=4) operands runs as
    broadcast-multiply-sum instead of ``dot_general``: the tiny products
    then stay elementwise work in the natural (N+1, B, 3, 3) buffer
    layout, which XLA fuses into the surrounding kernels, rather than
    one batched dot per 3x3 product.  Which form wins on a GPU is not
    measured yet."""
    return (
        a.dtype == jnp.float64 or b.dtype == jnp.float64
    ) and a.shape[-1] <= 4


def _matmul(a, b):
    if _use_vpu(a, b):
        return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)
    return jnp.einsum("...ij,...jk->...ik", a, b, precision="highest")


def _mm_T2(a, b):  # a @ b^T
    if _use_vpu(a, b):
        return jnp.sum(a[..., :, None, :] * b[..., None, :, :], axis=-1)
    return jnp.einsum("...ij,...kj->...ik", a, b, precision="highest")


def _T1_mm(a, b):  # a^T @ b
    if _use_vpu(a, b):
        return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)
    return jnp.einsum("...ji,...jk->...ik", a, b, precision="highest")


def _series_conv(xs, ys, k, transpose_y=False):
    """sum_{i=1..k-1} xs[i] @ ys[k-i] (optionally ys[k-i]^T); entries may
    be None (zero)."""
    terms = []
    for i in range(1, k):
        xi, yk = xs[i], ys[k - i]
        if xi is None or yk is None:
            continue
        terms.append(_mm_T2(xi, yk) if transpose_y else _matmul(xi, yk))
    return z_add(*terms)


def _series_conv_sym(xs, k, combine):
    """``sum_{i=1..k-1} combine(xs[i], xs[k-i])`` when the terms pair as
    transposes, ``combine(xs[k-i], xs[i]) == combine(xs[i], xs[k-i])^T``
    (a^T b / a b^T on any series; a @ b when every term is symmetric,
    e.g. the polar P series): only the ``i < k/2`` half is materialized,
    mirrored, plus the even-``k`` middle term once.  Halves the traced
    work of the unroll engine's SVD-W convolutions (the scan engine's
    analog is ``ScanEngine.buf_conv_sym``)."""
    terms = []
    for i in range(1, (k + 1) // 2):
        xi, yk = xs[i], xs[k - i]
        if xi is None or yk is None:
            continue
        t = combine(xi, yk)
        terms.append(t + jnp.swapaxes(t, -1, -2))
    if k % 2 == 0 and k >= 2 and xs[k // 2] is not None:
        terms.append(combine(xs[k // 2], xs[k // 2]))
    return z_add(*terms)


def _svd_taylor_rule(engine, eqn, idx, k, in_k, cache, commit):
    m_var = eqn.invars[0]
    m_k = in_k[0]
    u0, s0, w0 = engine.eqn_out0[idx]
    outs_used = engine.tfn.outs_used[idx]
    pw_mode = not (outs_used[0] or outs_used[1])
    B, n, _ = u0.shape
    v0 = _matmul(jnp.swapaxes(w0, -1, -2), u0)  # V0 = W0^T U0

    ud = engine.userdata.get(idx)
    if ud is None:
        t0 = u0 * s0[:, None, :]  # U0 S0
        p0 = _mm_T2(t0, u0)  # U0 S0 U0^T
        if pw_mode:
            ud = {"P": [p0], "W": [w0]}
        else:
            ud = {"U": [u0], "S": [s0], "W": [w0], "T": [t0], "PS": [p0]}
        engine.userdata[idx] = ud

    sp = s0[:, :, None] + s0[:, None, :]

    if pw_mode:
        return _svd_taylor_pw(
            engine, m_var, m_k, u0, s0, v0, w0, sp, ud, k, cache, commit
        )
    return _svd_taylor_usuw(
        engine, m_var, m_k, u0, s0, v0, w0, sp, ud, k, cache, commit
    )


def _svd_taylor_pw(engine, m_var, m_k, u0, s0, v0, w0, sp, ud, k, cache, commit):
    """Polar-mode order-k propagation (reference ``svd_w_taylor_fwd_p``,
    ``libsanm/tensor_svd.cpp:389-475``).

    Writing P = U S U^T, the series of P and W satisfy, at order k::

        P_k P_0 + P_0 P_k = M_k M_0^T + M_0 M_k^T + Bm_k - Bp_k
        W_k = P_0^{-1} (M_k - Bpw_k - P_k W_0)

    with the convolution biases Bm_k = sum_{0<i<k} M_i M_{k-i}^T,
    Bp_k = sum_{0<i<k} P_i P_{k-i}, Bpw_k = sum_{0<i<k} P_i W_{k-i}.
    Substituting P_k = U0 z U0^T turns the Sylvester equation into the
    per-entry solve (s_i + s_j) z_ij = [U0^T (...) U0]_ij."""
    P, W = ud["P"], ud["W"]
    ms = [engine.coeff(m_var, i) for i in range(k)]  # M_0..M_{k-1}

    if cache is None:
        bm = _series_conv_sym(ms, k, _mm_T2)
        bp = _series_conv_sym(P, k, _matmul)  # P_j symmetric
        bpw = _series_conv(P, W, k)
        cache = (bm, bp, bpw)
    bm, bp, bpw = cache

    if m_k is None and bm is None and bp is None and bpw is None:
        if commit:
            P.append(None)
            W.append(None)
        return [None, None, None], cache

    m_k_full = materialize(m_k, m_var.aval)
    c = z_add(bm, None if bp is None else -bp)
    e_terms = []
    if c is not None:
        e_terms.append(_matmul(_T1_mm(u0, c), u0))
    umv = _matmul(_T1_mm(u0, m_k_full), v0)  # U0^T M_k V0
    e_terms.append(umv * s0[:, None, :])
    e_terms.append(s0[:, :, None] * jnp.swapaxes(umv, -1, -2))
    e = z_add(*e_terms)
    z = clip_div(e, sp)
    p_k = _mm_T2(_matmul(u0, z), u0)  # U0 z U0^T
    resid = m_k_full - _matmul(p_k, w0)
    if bpw is not None:
        resid = resid - bpw
    s0inv = clip_div(jnp.ones_like(s0), s0)
    # P0^{-1} = U0 diag(1/s) U0^T
    w_k = _matmul(_mm_T2(u0 * s0inv[:, None, :], u0), resid)

    if commit:
        P.append(p_k)
        W.append(w_k)
    return [None, None, w_k], cache


def _svd_taylor_usuw(
    engine, m_var, m_k, u0, s0, v0, w0, sp, ud, k, cache, commit
):
    """Full-mode order-k propagation (reference ``svd_w_taylor_fwd``,
    ``libsanm/tensor_svd.cpp:275-387``).

    With E = U0^T (M_k - Mb_k) V0, the order-k equations of
    M = U S U^T W, U^T U = I, W^T W = I reduce to::

        (s_i + s_j) x_ij = (E - E^T - V0^T Bw_k V0 S0)_ij ,  W_k = U0 x V0^T
        eqb = (E - S0 x)^T + Bu_k S0
        S_k = diag(eqb) ;   (s_i - s_j) G_ji = eqb_ij (i != j), U_k = U0 G

    where Bu_k, Bw_k are the convolution biases of U^T U and W^T W and
    Mb_k is the bias of the 4-fold product (kept O(k) per order through
    cached partial-product series T = U*S and PS = U S U^T)."""
    U, S, W, T, PS = ud["U"], ud["S"], ud["W"], ud["T"], ud["PS"]

    if cache is None:
        # T_k^partial = sum_{a=1..k-1} U_a S_{k-a}
        t_terms = []
        for a in range(1, k):
            ua, ska = U[a], S[k - a]
            if ua is None or ska is None:
                continue
            t_terms.append(ua * ska[:, None, :])
        t_part = z_add(*t_terms)
        # PS_k^partial = T_k^partial U0^T + sum_{c=1..k-1} T_{k-c} U_c^T
        ps_terms = []
        if t_part is not None:
            ps_terms.append(_mm_T2(t_part, u0))
        for c in range(1, k):
            tc, uc = T[k - c], U[c]
            if tc is None or uc is None:
                continue
            ps_terms.append(_mm_T2(tc, uc))
        ps_part = z_add(*ps_terms)
        # Mb_k = sum_{j=1..k-1} PS_{k-j} W_j + PS_k^partial W_0
        mb_terms = []
        for j in range(1, k):
            psj, wj = PS[k - j], W[j]
            if psj is None or wj is None:
                continue
            mb_terms.append(_matmul(psj, wj))
        if ps_part is not None:
            mb_terms.append(_matmul(ps_part, w0))
        mb = z_add(*mb_terms)
        bu = _series_conv_sym(U, k, _T1_mm)
        bw = _series_conv_sym(W, k, _T1_mm)
        cache = (mb, bu, bw, t_part, ps_part)
    mb, bu, bw, t_part, ps_part = cache

    if m_k is None and mb is None and bu is None and bw is None:
        if commit:
            for lst in (U, S, W, T, PS):
                lst.append(None)
        return [None, None, None], cache

    B, n, _ = u0.shape
    dtype = u0.dtype
    m_k_full = materialize(m_k, m_var.aval)
    mmb = m_k_full if mb is None else m_k_full - mb
    e = _matmul(_T1_mm(u0, mmb), v0)  # U0^T (M_k - Mb) V0
    et = jnp.swapaxes(e, -1, -2)
    bw_full = jnp.zeros((B, n, n), dtype) if bw is None else bw
    bu_full = jnp.zeros((B, n, n), dtype) if bu is None else bu
    cmat = _matmul(_T1_mm(v0, bw_full), v0)  # V0^T Bw V0
    rhs_w = e - et - cmat * s0[:, None, :]
    x = clip_div(rhs_w, sp)
    w_k = _mm_T2(_matmul(u0, x), v0)  # U0 x V0^T

    eqb = jnp.swapaxes(e - s0[:, :, None] * x, -1, -2) + bu_full * s0[
        :, None, :
    ]
    s_k = jnp.diagonal(eqb, axis1=-2, axis2=-1)
    sm = s0[:, :, None] - s0[:, None, :]
    zmat = clip_div(eqb, sm)
    yu = jnp.triu(zmat, 1)
    bu_diag = jnp.diagonal(bu_full, axis1=-2, axis2=-1)
    y = (
        yu
        - jnp.swapaxes(yu, -1, -2)
        - jnp.tril(bu_full, -1)
        - 0.5 * bu_diag[:, :, None] * jnp.eye(n, dtype=dtype)
    )
    u_k = _mm_T2(u0, y)  # U0 Y^T

    if commit:
        U.append(u_k)
        S.append(s_k)
        W.append(w_k)
        t_k = z_add(
            t_part,
            u0 * s_k[:, None, :],
            u_k * s0[:, None, :],
        )
        T.append(t_k)
        ps_terms = []
        if ps_part is not None:
            ps_terms.append(ps_part)
        delta_t = z_add(t_k, None if t_part is None else -t_part)
        if delta_t is not None:
            ps_terms.append(_mm_T2(delta_t, u0))
        ps_terms.append(_mm_T2(T[0], u_k))
        PS.append(z_add(*ps_terms))
    return [u_k, s_k, w_k], cache


taylor.register_rule(
    svd_w_p,
    _svd_taylor_rule,
    lambda eqn, vy: ([True], [False, False, False]),
)


# ----------------------------------------------------------------------------
# scan-mode Taylor rule (buffered history, traced order index k);
# see sanm_tpu.taylor_scan
# ----------------------------------------------------------------------------


def _svd_scan_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    from .. import taylor_scan

    m_var = eqn.invars[0]
    m_k = in_k[0]
    if engine.is_const(m_var):
        return [None, None, None], cache, None
    u0, s0, w0 = engine.eqn_out0[idx]
    outs_used = engine.tfn.outs_used[idx]
    pw_mode = not (outs_used[0] or outs_used[1])
    v0 = _matmul(jnp.swapaxes(w0, -1, -2), u0)
    sp = s0[:, :, None] + s0[:, None, :]
    ud = taylor_scan._ud_dict(engine, carry, idx)
    mbuf = engine.buf(carry, m_var)
    m_k_full = materialize(m_k, m_var.aval)

    if pw_mode:
        # sorted userdata keys: ["P", "W"]
        Pbuf, Wbuf = ud["P"], ud["W"]
        if cache is None:
            # bm/bp terms pair as transposes (P_j symmetric), so the
            # halved symmetric form applies; bpw (P_i W_{k-i}) does not
            bm = engine.buf_conv_sym(carry, mbuf, k, combine=_mm_T2)
            bp = engine.buf_conv_sym(carry, Pbuf, k, combine=_matmul)
            bpw = engine.buf_conv(carry, Pbuf, Wbuf, k, combine=_matmul)
            cache = (bm, bp, bpw)
        bm, bp, bpw = cache
        c = bm - bp
        e = _matmul(_T1_mm(u0, c), u0)
        umv = _matmul(_T1_mm(u0, m_k_full), v0)
        e = e + umv * s0[:, None, :] + s0[:, :, None] * jnp.swapaxes(
            umv, -1, -2
        )
        z = clip_div(e, sp)
        p_k = _mm_T2(_matmul(u0, z), u0)
        resid = m_k_full - _matmul(p_k, w0) - bpw
        s0inv = clip_div(jnp.ones_like(s0), s0)
        w_k = _matmul(_mm_T2(u0 * s0inv[:, None, :], u0), resid)
        ud_update = [p_k, w_k] if commit else None
        return [None, None, w_k], cache, ud_update

    # full mode; sorted keys: ["PS", "S", "T", "U", "W"]
    PS, S, T, U, W = ud["PS"], ud["S"], ud["T"], ud["U"], ud["W"]
    if cache is None:
        t_part = engine.buf_conv(
            carry, U, S, k, combine=lambda u, s: u * s[:, None, :]
        )
        ps_tail = engine.buf_conv(
            carry, U, T, k, combine=lambda u_c, t_kc: _mm_T2(t_kc, u_c)
        )
        ps_part = _mm_T2(t_part, u0) + ps_tail
        mb_head = engine.buf_conv(
            carry, W, PS, k, combine=lambda w_j, ps: _matmul(ps, w_j)
        )
        mb = mb_head + _matmul(ps_part, w0)
        bu = engine.buf_conv_sym(carry, U, k, combine=_T1_mm)
        bw = engine.buf_conv_sym(carry, W, k, combine=_T1_mm)
        cache = (mb, bu, bw, t_part, ps_part)
    mb, bu, bw, t_part, ps_part = cache

    B, n, _ = u0.shape
    dtype = u0.dtype
    e = _matmul(_T1_mm(u0, m_k_full - mb), v0)
    et = jnp.swapaxes(e, -1, -2)
    cmat = _matmul(_T1_mm(v0, bw), v0)
    x = clip_div(e - et - cmat * s0[:, None, :], sp)
    w_k = _mm_T2(_matmul(u0, x), v0)
    eqb = jnp.swapaxes(e - s0[:, :, None] * x, -1, -2) + bu * s0[:, None, :]
    s_k = jnp.diagonal(eqb, axis1=-2, axis2=-1)
    sm = s0[:, :, None] - s0[:, None, :]
    yu = jnp.triu(clip_div(eqb, sm), 1)
    bu_diag = jnp.diagonal(bu, axis1=-2, axis2=-1)
    y = (
        yu
        - jnp.swapaxes(yu, -1, -2)
        - jnp.tril(bu, -1)
        - 0.5 * bu_diag[:, :, None] * jnp.eye(n, dtype=dtype)
    )
    u_k = _mm_T2(u0, y)
    ud_update = None
    if commit:
        t_k = t_part + u0 * s_k[:, None, :] + u_k * s0[:, None, :]
        ps_k = ps_part + _mm_T2(t_k - t_part, u0) + _mm_T2(T[0], u_k)
        # sorted keys order: PS, S, T, U, W
        ud_update = [ps_k, s_k, t_k, u_k, w_k]
    return [u_k, s_k, w_k], cache, ud_update


def _register_scan_rule():
    from .. import taylor_scan

    taylor_scan.register_scan_rule(svd_w_p, _svd_scan_rule)


_register_scan_rule()
