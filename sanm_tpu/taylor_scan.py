"""Scan-mode Taylor propagation: the order loop as ``lax.scan``.

The plain engine (:mod:`sanm_tpu.taylor`) unrolls the order loop at
trace time — transparent, but the XLA program grows as O(order^2)
convolution terms, so the compile time of an order-20 FEA expansion
grows with it.  This module re-expresses orders
k >= 2 as a ``lax.scan`` whose body is traced ONCE:

* every series that the recurrences need lives in a preallocated
  ``(N+1, ...)`` buffer updated with ``dynamic_update_index``;
* convolutions ``sum_{i=1..k-1} a_i * b_{k-i}`` become masked
  full-window contractions (gather ``b`` at ``k - i``, mask ``i < k``)
  — O(N) work per order instead of O(k), in exchange for an N-fold
  smaller program;
* orders 0 and 1 stay outside the scan (order 1 builds the Jacobian
  and the factorization, exactly like the reference's first iteration,
  ``libsanm/anm.cpp:223-291``).

The per-primitive rules mirror :mod:`sanm_tpu.taylor`'s registry but
operate on buffers with a *traced* order index.
"""

from __future__ import annotations

import operator
from functools import partial
from typing import Any, Callable, Dict, List

import jax
import jax.numpy as jnp
from jax import lax
from jax._src import core as jcore

from .taylor import TaylorFn, _hi_params, _static_scalar, materialize, z_add
from .utils import SANMError

SCAN_RULES: Dict[Any, Callable] = {}


def register_scan_rule(prim, rule):
    SCAN_RULES[prim] = rule


class ScanEngine:
    """Order-k propagation with buffered history and traced k.

    Usage (inside a jit trace):
        eng = ScanEngine(plain_engine, order)     # after plain engine has
                                                  # committed orders 0..1
        carry = eng.init_carry()
        # inside lax.scan body, at traced order k:
        b_out, caches = eng.order_bias(carry, k)
        ...solve for x_k...
        carry = eng.push(carry, k, x_k, caches)
    """

    def __init__(self, plain_engine, order: int, cap: int | None = None):
        self._static_init(plain_engine.tfn, order, cap)
        self.eqn_out0 = plain_engine.eqn_out0
        self._env0 = plain_engine._env0

        # initial buffers from the plain engine's committed orders
        bufs = []
        for v in self.hist_vars:
            h = plain_engine.hist[v]
            v0 = h[0]
            buf = jnp.zeros((self.cap + 1,) + v0.shape, v0.dtype)
            for i, hv in enumerate(h):
                if hv is not None:
                    buf = buf.at[i].set(hv)
            bufs.append(buf)
        self._init_bufs = bufs

        # userdata buffers (svd series, integer_pow chains), same idea;
        # enumerated in live-eqn order so structures are reproducible
        ud_bufs = []
        for idx, eqn, _ in self.tfn.live_eqns:
            if idx not in plain_engine.userdata:
                continue
            spec, flats = _stack_userdata(
                plain_engine.userdata[idx], self.cap
            )
            self._ud_spec[idx] = (len(ud_bufs), spec)
            ud_bufs.extend(flats)
        self._init_ud = ud_bufs

    def _static_init(self, tfn: TaylorFn, order: int, cap: int | None = None):
        """Trace-independent structure (shared by the live-trace and the
        aux-reconstruction constructors).

        ``cap`` is the history-buffer capacity (highest stored order):
        buffers are ``(cap + 1, ...)`` and the masked convolution windows
        run over ``cap + 1`` slots.  An engine with ``cap < order`` is a
        *stage* engine, valid for ``push`` at k <= cap and ``order_bias``
        at k <= cap + 1 — the two-level order loop runs orders <= N/2 on
        a half-capacity engine (half the convolution work per order,
        ~25% of total conv cost; the window is read in full every order
        regardless of k), then pads the carry to full capacity
        (``promote_carry``) and finishes on the full engine."""
        self.tfn = tfn
        self.jaxpr = tfn.jaxpr
        self.N = int(order)
        self.cap = self.N if cap is None else int(cap)
        self._const_vars = set(self.jaxpr.constvars)
        self._ud_spec = {}
        # deterministic var ordering: constvars, invars, live outvars
        ordered = list(self.jaxpr.constvars) + list(self.jaxpr.invars)
        for idx, eqn, _ in tfn.live_eqns:
            for v in eqn.outvars:
                if not isinstance(v, jcore.DropVar):
                    ordered.append(v)
        self._env0_vars = ordered
        self.hist_vars = [v for v in ordered if v in tfn.need_hist]
        self._hist_index = {v: i for i, v in enumerate(self.hist_vars)}
        self._multiout_idxs = [
            idx
            for idx, eqn, _ in tfn.live_eqns
            if eqn.primitive.multiple_results
        ]

    # -- aux packing: order-0 values as explicit pytrees (so separately
    # jitted stages can rebuild the engine from runtime arguments) -------
    def pack_aux(self):
        env0 = tuple(self._env0[v] for v in self._env0_vars)
        out0 = tuple(
            tuple(self.eqn_out0[idx]) for idx in self._multiout_idxs
        )
        return (env0, out0)

    @classmethod
    def from_aux(cls, tfn: TaylorFn, order: int, aux, cap: int | None = None):
        """Rebuild from packed aux (inside another jit trace)."""
        self = cls.__new__(cls)
        self._static_init(tfn, order, cap)
        env0, out0 = aux
        self._env0 = dict(zip(self._env0_vars, env0))
        self.eqn_out0 = {
            idx: list(outs)
            for idx, outs in zip(self._multiout_idxs, out0)
        }
        # _ud_spec layout must match the live-trace constructor: rebuild
        # base offsets by walking live eqns with static ud specs
        base = 0
        for idx, eqn, outs_used in tfn.live_eqns:
            spec = _static_ud_spec(tfn, idx, eqn, outs_used)
            if spec is None:
                continue
            kind, meta = spec
            nbufs = len(meta) if kind == "dict" else meta
            self._ud_spec[idx] = (base, spec)
            base += nbufs
        self._init_bufs = None
        self._init_ud = None
        return self

    # -- carry ------------------------------------------------------------
    def init_carry(self):
        return (tuple(self._init_bufs), tuple(self._init_ud))

    # -- helpers used by rules ---------------------------------------------
    def coeff0(self, var):
        if isinstance(var, jcore.Literal):
            return var.val
        return self._env0[var]

    def is_const(self, var):
        """True when the var has no usable coefficients beyond order 0:
        literals, consts, const-derived vars, and vars whose history was
        pruned (pruning only happens when every convolution partner is
        const, so the conv is legitimately zero)."""
        if isinstance(var, jcore.Literal):
            return True
        return (
            var not in self.tfn.varying
            or var not in self.tfn.need_hist
            or var in self._const_vars
        )

    def buf(self, carry, var):
        return carry[0][self._hist_index[var]]

    def _mask(self, k, lo=1):
        idx = jnp.arange(self.cap + 1)
        return idx, (idx >= lo) & (idx <= k - 1)

    @staticmethod
    def _wreduce(w, terms):
        """Masked window reduction ``sum_i w[i] * terms[i]`` (a
        dot_general over the window axis)."""
        return jnp.tensordot(w, terms, axes=(0, 0))

    def pair_conv(
        self, carry, a_var, b_var, k, weight=None, combine=None, lo=1
    ):
        """sum_{i=lo..k-1} w(i,k) * combine(a_i, b_{k-i}); None if either
        operand is constant (zero higher orders)."""
        if self.is_const(a_var) or self.is_const(b_var):
            return None
        A = self.buf(carry, a_var)
        Bb = self.buf(carry, b_var)
        idx, mask = self._mask(k, lo)
        Bg = jnp.take(Bb, jnp.clip(k - idx, 0, self.cap), axis=0)
        if combine is None:
            terms = A * Bg
        else:
            terms = jax.vmap(combine)(A, Bg)
        w = mask.astype(terms.dtype)
        if weight is not None:
            w = w * weight(idx.astype(terms.dtype), k)
        return self._wreduce(w, terms)

    def buf_conv(self, carry, bufA, bufB, k, combine=None, lo=1,
                 weight=None):
        """Like pair_conv but on explicit (N+1, ...) buffers."""
        idx, mask = self._mask(k, lo)
        Bg = jnp.take(bufB, jnp.clip(k - idx, 0, self.cap), axis=0)
        terms = (bufA * Bg) if combine is None else jax.vmap(combine)(
            bufA, Bg
        )
        w = mask.astype(terms.dtype)
        if weight is not None:
            w = w * weight(idx.astype(terms.dtype), k)
        return self._wreduce(w, terms)

    def buf_conv_sym(self, carry, buf, k, combine):
        """``sum_{i=1..k-1} combine(buf[i], buf[k-i])`` for self-
        convolutions whose terms pair as matrix transposes,
        ``combine(buf[k-i], buf[i]) == combine(buf[i], buf[k-i])^T``
        (holds for a^T b and a b^T on any series, and for a @ b when
        every series term is symmetric, e.g. the polar-factor P series
        of SVD-W).  Computes only the ``i < k/2`` half over a
        STATICALLY-halved buffer prefix, mirrors it, and adds the
        even-``k`` middle term once — mathematically equal to
        ``buf_conv(buf, buf)`` but with ~half the combine work and
        buffer reads per order.  That matters in the emulated-f64
        island, where these convolutions dominate the ARAP per-order
        step (``ops/svd_w.py:_svd_scan_rule``)."""
        h = self.cap // 2 + 1  # slots 0..h-1 cover every i < k/2, k <= cap+1
        idx = jnp.arange(h)
        mask = (idx >= 1) & (2 * idx < k)
        Bg = jnp.take(buf, jnp.clip(k - idx, 0, self.cap), axis=0)
        terms = jax.vmap(combine)(buf[:h], Bg)
        C = self._wreduce(mask.astype(terms.dtype), terms)
        res = C + jnp.swapaxes(C, -1, -2)
        mid_i = k // 2
        a_mid = jax.lax.dynamic_index_in_dim(
            buf, mid_i, axis=0, keepdims=False
        )
        mid = combine(a_mid, a_mid)
        even = ((k % 2) == 0) & (mid_i >= 1)
        return res + jnp.where(even, 1, 0).astype(res.dtype) * mid

    def coeff_prev(self, carry, var, i):
        """Dynamic single-order read buf[var][i] (i traced)."""
        return jax.lax.dynamic_index_in_dim(
            self.buf(carry, var), i, axis=0, keepdims=False
        )

    # -- passes -------------------------------------------------------------
    def _run(self, carry, k, in_ks, caches, commit):
        env_k = {}
        for v, xk in zip(self.jaxpr.invars, in_ks):
            env_k[v] = xk

        def read_k(v):
            if isinstance(v, jcore.Literal):
                return None
            return env_k.get(v)

        out_caches = {}
        new_ud = list(carry[1])
        for idx, eqn, outs_used in self.tfn.live_eqns:
            rule = SCAN_RULES.get(eqn.primitive)
            if rule is None:
                raise SANMError(
                    "no scan Taylor rule for %r" % eqn.primitive.name
                )
            in_k = [read_k(v) for v in eqn.invars]
            cache = caches.get(idx) if caches is not None else None
            out_k, cache, ud = rule(
                self, carry, eqn, idx, k, in_k, cache, commit
            )
            out_caches[idx] = cache
            if commit and ud is not None:
                base, spec = self._ud_spec[idx]
                for j, u in enumerate(ud):
                    if u is not None:
                        new_ud[base + j] = lax.dynamic_update_index_in_dim(
                            new_ud[base + j], u, k, axis=0
                        )
            for v, o in zip(eqn.outvars, out_k):
                if not isinstance(v, jcore.DropVar):
                    env_k[v] = o

        outs = [read_k(v) for v in self.jaxpr.outvars]
        if not commit:
            return outs, out_caches
        new_bufs = []
        for v, buf in zip(self.hist_vars, carry[0]):
            val = env_k.get(v)
            if val is None and v in self.jaxpr.invars:
                val = in_ks[list(self.jaxpr.invars).index(v)]
            if val is None:
                val = jnp.zeros(buf.shape[1:], buf.dtype)
            new_bufs.append(
                lax.dynamic_update_index_in_dim(buf, val, k, axis=0)
            )
        return outs, (tuple(new_bufs), tuple(new_ud))

    def order_bias(self, carry, k):
        outs, caches = self._run(
            carry, k, [None] * len(self.jaxpr.invars), None, commit=False
        )
        out = outs[0] if len(outs) == 1 else tuple(outs)
        return out, caches

    def push(self, carry, k, xks, caches):
        if not isinstance(xks, (list, tuple)):
            xks = [xks]
        outs, new_carry = self._run(carry, k, list(xks), caches, True)
        return new_carry


def promote_carry(carry, new_cap: int):
    """Pad a stage engine's carry (history + userdata buffers, all
    stacked per-order along axis 0) to ``new_cap + 1`` slots with zeros.
    The two-level order loop calls this once, at the stage boundary
    k = N//2, before switching to the full-capacity step program."""

    def pad(b):
        extra = new_cap + 1 - b.shape[0]
        if extra <= 0:
            return b
        return jnp.concatenate(
            [b, jnp.zeros((extra,) + b.shape[1:], b.dtype)], axis=0
        )

    bufs, ud = carry
    return (tuple(pad(b) for b in bufs), tuple(pad(b) for b in ud))


def _static_ud_spec(tfn, idx, eqn, outs_used):
    """Static userdata spec for an eqn (must mirror what the plain rules
    create): returns ("dict", sorted_keys) / ("list", n) / None."""
    from .ops.svd_w import svd_w_p

    if eqn.primitive is svd_w_p:
        pw = not (outs_used[0] or outs_used[1])
        return ("dict", ["P", "W"] if pw else ["PS", "S", "T", "U", "W"])
    if eqn.primitive is lax.integer_pow_p:
        n = eqn.params["y"]
        if n >= 2:
            from .taylor import _binary_chain

            chain, _ = _binary_chain(n)
            return ("list", len(chain) + 1)
        return None
    return None


def _stack_userdata(ud, N):
    """Convert the plain engine's per-eqn userdata (lists of per-order
    values, possibly nested) to stacked buffers.

    Supports: list of per-order values (integer_pow chain entries are a
    list of such lists), and dicts of per-order lists (svd series)."""
    if isinstance(ud, dict):
        keys = sorted(ud.keys())
        flats = []
        for key in keys:
            flats.append(_stack_series(ud[key], N))
        return ("dict", keys), flats
    if isinstance(ud, list) and ud and isinstance(ud[0], list):
        flats = [_stack_series(s, N) for s in ud]
        return ("list", len(ud)), flats
    raise SANMError("unsupported userdata for scan mode: %r" % type(ud))


def _stack_series(series, N):
    ref = next(x for x in series if x is not None)
    buf = jnp.zeros((N + 1,) + ref.shape, ref.dtype)
    for i, x in enumerate(series):
        if x is not None:
            buf = buf.at[i].set(x)
    return buf


def _ud_dict(engine, carry, idx):
    """View an eqn's userdata buffers as a dict/list again."""
    base, spec = engine._ud_spec[idx]
    kind, meta = spec
    bufs = carry[1]
    if kind == "dict":
        return {key: bufs[base + j] for j, key in enumerate(meta)}
    return [bufs[base + j] for j in range(meta)]


# ----------------------------------------------------------------------------
# scan rules
# ----------------------------------------------------------------------------

from jax import lax as _lax  # noqa: E402


def _lin_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    if all(x is None for x in in_k):
        return [None] * len(eqn.outvars), cache, None
    vals = [
        materialize(x, v.aval) if x is None else x
        for x, v in zip(in_k, eqn.invars)
    ]
    outs = eqn.primitive.bind(*vals, **_hi_params(eqn))
    if not eqn.primitive.multiple_results:
        outs = [outs]
    return outs, cache, None


for _p in [
    _lax.transpose_p, _lax.reshape_p, _lax.broadcast_in_dim_p,
    _lax.squeeze_p, _lax.slice_p, _lax.concatenate_p, _lax.reduce_sum_p,
    _lax.convert_element_type_p, _lax.neg_p, _lax.rev_p,
]:
    register_scan_rule(_p, _lin_rule)


def _const_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    return [None] * len(eqn.outvars), cache, None


register_scan_rule(_lax.iota_p, _const_rule)
for _p in [_lax.eq_p, _lax.ne_p, _lax.lt_p, _lax.le_p, _lax.gt_p,
           _lax.ge_p, _lax.and_p, _lax.or_p, _lax.not_p]:
    register_scan_rule(_p, _const_rule)


def _select_n_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    if in_k[0] is not None:
        raise SANMError("select_n predicate must be order-0 constant")
    if all(x is None for x in in_k[1:]):
        return [None], cache, None
    cases = [
        materialize(x, v.aval) if x is None else x
        for x, v in zip(in_k[1:], eqn.invars[1:])
    ]
    return [_lax.select_n(engine.coeff0(eqn.invars[0]), *cases)], cache, None


register_scan_rule(_lax.select_n_p, _select_n_rule)


def _bshape(out, aval):
    if out is not None and out.shape != aval.shape:
        return jnp.broadcast_to(out, aval.shape)
    return out


def _add_rule(sign):
    def rule(engine, carry, eqn, idx, k, in_k, cache, commit):
        u_k, v_k = in_k
        out = z_add(u_k, None if v_k is None else sign * v_k)
        return [_bshape(out, eqn.outvars[0].aval)], cache, None

    return rule


register_scan_rule(_lax.add_p, _add_rule(1.0))
register_scan_rule(_lax.sub_p, _add_rule(-1.0))


def _mul_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    u, v = eqn.invars
    u_k, v_k = in_k
    if cache is None:
        cache = engine.pair_conv(carry, u, v, k)
    out = z_add(
        None if v_k is None else engine.coeff0(u) * v_k,
        None if u_k is None else u_k * engine.coeff0(v),
        cache,
    )
    return [_bshape(out, eqn.outvars[0].aval)], cache, None


register_scan_rule(_lax.mul_p, _mul_rule)


def _div_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    u, v = eqn.invars
    w = eqn.outvars[0]
    u_k, v_k = in_k
    if cache is None:
        cache = engine.pair_conv(carry, w, v, k)
    num = z_add(
        u_k,
        None if v_k is None else -(engine.coeff0(w) * v_k),
        None if cache is None else -cache,
    )
    out = None if num is None else num / engine.coeff0(v)
    return [_bshape(out, w.aval)], cache, None


register_scan_rule(_lax.div_p, _div_rule)


def _dot_general_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    u, v = eqn.invars
    u_k, v_k = in_k
    bind = partial(_lax.dot_general_p.bind, **eqn.params)
    if cache is None:
        cache = engine.pair_conv(carry, u, v, k, combine=bind)
    t1 = None if v_k is None else bind(engine.coeff0(u), v_k)
    t2 = None if u_k is None else bind(u_k, engine.coeff0(v))
    return [z_add(t1, t2, cache)], cache, None


register_scan_rule(_lax.dot_general_p, _dot_general_rule)


def _pow_like_rule(get_p):
    def rule(engine, carry, eqn, idx, k, in_k, cache, commit):
        p = get_p(engine, eqn)
        x = eqn.invars[0]
        f = eqn.outvars[0]
        x_k = in_k[0]
        x0 = engine.coeff0(x)
        f0 = engine.coeff0(f)
        kf = k.astype(x0.dtype) if hasattr(k, "astype") else float(k)
        if cache is None:
            # sum_{i=1..k-1} ((i/k)(p+1)-1) * x_i * f_{k-i}
            s = engine.pair_conv(
                carry, x, f, k,
                weight=lambda i, kk: (i / kf) * (p + 1.0) - 1.0,
            )
            cache = None if s is None else s / x0
        lin = None if x_k is None else (p * f0 / x0) * x_k
        return [z_add(lin, cache)], cache, None

    return rule


register_scan_rule(
    _lax.pow_p,
    _pow_like_rule(lambda eng, eqn: _static_scalar(eng, eqn.invars[1])),
)
register_scan_rule(_lax.sqrt_p, _pow_like_rule(lambda e, q: 0.5))
register_scan_rule(_lax.rsqrt_p, _pow_like_rule(lambda e, q: -0.5))


def _log_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    x = eqn.invars[0]
    f = eqn.outvars[0]
    x_k = in_k[0]
    x0 = engine.coeff0(x)
    kf = k.astype(x0.dtype)
    if cache is None:
        s = engine.pair_conv(
            carry, f, x, k, weight=lambda i, kk: i / kf
        )
        cache = None if s is None else -s / x0
    lin = None if x_k is None else x_k / x0
    return [z_add(lin, cache)], cache, None


register_scan_rule(_lax.log_p, _log_rule)


def _exp_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    x = eqn.invars[0]
    f = eqn.outvars[0]
    x_k = in_k[0]
    f0 = engine.coeff0(f)
    kf = k.astype(f0.dtype)
    if cache is None:
        cache = engine.pair_conv(
            carry, x, f, k, weight=lambda i, kk: i / kf
        )
    lin = None if x_k is None else f0 * x_k
    return [z_add(lin, cache)], cache, None


register_scan_rule(_lax.exp_p, _exp_rule)


def _integer_pow_rule(engine, carry, eqn, idx, k, in_k, cache, commit):
    from .taylor import _binary_chain

    n = eqn.params["y"]
    x = eqn.invars[0]
    x_k = in_k[0]
    if n == 1:
        return [x_k], cache, None
    if n == 0:
        return [None], cache, None
    if n < 0:
        return _pow_like_rule(lambda e, q: float(n))(
            engine, carry, eqn, idx, k, in_k, cache, commit
        )
    if engine.is_const(x):
        return [None], cache, None
    chain, out_idx = _binary_chain(n)
    series = _ud_dict(engine, carry, idx)  # list of (N+1, ...) buffers
    xbuf = engine.buf(carry, x)
    bufs = [xbuf] + list(series[1:])  # V[0] = x, V[i] = chain value i

    if cache is None:
        cache = [
            engine.buf_conv(carry, bufs[ia], bufs[ib], k)
            for (ia, ib) in chain
        ]

    cur_k = [None] * (len(chain) + 1)
    cur_k[0] = x_k
    for ci, (ia, ib) in enumerate(chain):
        a0 = bufs[ia][0]
        b0 = bufs[ib][0]
        cur_k[ci + 1] = z_add(
            None if cur_k[ib] is None else a0 * cur_k[ib],
            None if cur_k[ia] is None else cur_k[ia] * b0,
            cache[ci],
        )

    ud_update = None
    if commit:
        # userdata layout: [x_series_placeholder, chain value series...]
        ud_update = [None] + [
            materialize(cur_k[i + 1], jcore.ShapedArray(
                bufs[i + 1].shape[1:], bufs[i + 1].dtype))
            for i in range(len(chain))
        ]
    return [cur_k[out_idx]], cache, ud_update


register_scan_rule(_lax.integer_pow_p, _integer_pow_rule)
