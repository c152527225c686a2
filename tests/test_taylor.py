"""Per-operator Taylor propagation property tests.

Port of the reference test strategy (``tests/symbolic.cpp:89-137``,
``check_taylor_prop``): for every order k the engine must satisfy the
defining affine invariant  f_k == J @ x_k + b_k,  and the truncated
series must match plain evaluation of the function at sample points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sanm_tpu import taylor
from sanm_tpu.ops import (
    batched_det,
    batched_inv,
    batched_mul_eye,
    batched_transpose,
    svd_w,
    polar_w,
)
from helper import tensor_rng, require_tensor_eq


def eval_series(coeffs, a):
    acc = np.zeros_like(np.asarray(coeffs[0]))
    for c in reversed(coeffs):
        acc = acc * a + (0.0 if c is None else np.asarray(c))
    return acc


def apply_jacobian(J, x_k):
    # J: (B, odim, idim), x_k: (B, *in_inner) -> (B, odim)
    B = x_k.shape[0]
    return jnp.einsum("boi,bi->bo", J, x_k.reshape(B, -1))


def check_taylor_prop(
    fn,
    xarr,
    avals,
    eps_coeff=1e-7,
    eps_eval=1e-5,
    batched=True,
):
    """xarr: list of input coefficient arrays (order 0..N).

    The whole propagation runs inside one jit (as in the real drivers);
    host-side asserts check the per-order affine invariant and
    series-vs-eval agreement."""
    tfn = taylor.TaylorFn(fn, jnp.asarray(xarr[0]))

    def full(x0, xks):
        eng = tfn.engine()
        y0 = eng.start(x0)
        out_shape = y0.shape
        ys, bs = [y0], []
        for xk in xks:
            bk = eng.order_bias()
            yk = eng.push(xk)
            ys.append(jnp.zeros(out_shape) if yk is None else yk)
            bs.append(jnp.zeros(out_shape) if bk is None else bk)
        J = (
            taylor.batched_jacobian(fn, x0)
            if batched
            else jnp.zeros(())
        )
        return jnp.stack(ys), jnp.stack(bs), J

    x0 = jnp.asarray(xarr[0])
    xks = [jnp.asarray(x) for x in xarr[1:]]
    yarr, barr, J = jax.jit(full)(x0, xks)
    yarr, barr = np.asarray(yarr), np.asarray(barr)
    out_shape = yarr.shape[1:]

    if batched:
        for k in range(1, len(xarr)):
            lin = np.asarray(apply_jacobian(J, jnp.asarray(xarr[k]))).reshape(
                out_shape
            )
            require_tensor_eq(
                lin + barr[k - 1],
                yarr[k],
                eps_coeff,
                msg=f"affine invariant at order {k}",
            )

    for a in avals:
        xt = eval_series(xarr, a)
        yt = eval_series(list(yarr), a)
        yget = np.asarray(tfn(jnp.asarray(xt)))
        require_tensor_eq(yt, yget, eps_eval, msg=f"series vs eval at a={a}")


def _zeros_tail(xarr, n):
    return xarr + [np.zeros_like(xarr[0])] * n


# ---------------------------------------------------------------------------


class TestElemwise:
    def test_mul_square(self):
        xarr = [tensor_rng((5, 4), 0.5, 2.0) for _ in range(4)]
        check_taylor_prop(lambda x: x * x, _zeros_tail(xarr, 4), [0.05, -0.05])

    def test_mul_three_way(self):
        xarr = [tensor_rng((5, 4), 0.5, 2.0) for _ in range(4)]
        check_taylor_prop(
            lambda x: (x * 2.0 + 1.0) * (x - 0.5) * x,
            _zeros_tail(xarr, 4),
            [0.05, -0.05],
        )

    def test_div(self):
        xarr = [tensor_rng((5, 4), 1.0, 2.0) for _ in range(4)]
        check_taylor_prop(
            lambda x: (x + 1.0) / (x * x + 0.5),
            _zeros_tail(xarr, 4),
            [0.02, -0.02],
        )

    @pytest.mark.parametrize("p", [2.3, -1.0, 0.5, -5.0 / 3.0])
    def test_pow(self, p):
        xarr = [tensor_rng((5, 4), 1.0, 2.0) for _ in range(4)]
        check_taylor_prop(
            lambda x: x**p, _zeros_tail(xarr, 4), [0.02, -0.02]
        )

    @pytest.mark.parametrize("n", [2, 3, 5, 6, 8, 15])
    def test_integer_pow(self, n):
        # includes exact zeros in x0 — the conv path must handle them
        # (reference zero-base integer power,
        # libsanm/analytic_unary.cpp:105-131)
        xarr = [tensor_rng((5, 4), -1.0, 1.0) for _ in range(5)]
        xarr[0][0, 0] = 0.0
        xarr[0][1, 2] = 0.0
        check_taylor_prop(
            lambda x: x**n, _zeros_tail(xarr, 4), [0.05, -0.05], eps_eval=1e-4
        )

    @pytest.mark.parametrize("p", [2.0, 3.0])
    def test_pow_float_integral_exponent_zero_base(self, p):
        # (p = 0.0 is excluded: jax's own pow JVP is NaN at a zero
        # base — 0 * x^-1 — which breaks the test's Jacobian oracle,
        # not the series rule)
        # lax.pow with an integral float exponent at x0 containing
        # exact zeros must route through the convolution chain (the
        # reference's |x0|<1e-3 switch for integral exponents,
        # libsanm/analytic_unary.cpp:105-131) instead of dividing by x0
        xarr = [tensor_rng((5, 4), -1.0, 1.0) for _ in range(4)]
        xarr[0][0, 0] = 0.0
        xarr[0][2, 3] = 0.0
        # tail long enough that the full degree-3p polynomial fits: the
        # series-vs-eval check is then exact, not truncation-limited
        check_taylor_prop(
            lambda x: jax.lax.pow(x, p),
            _zeros_tail(xarr, 7),
            [0.05, -0.05],
        )

    def test_pow_zero_base_noninteger_raises(self):
        # 0**p, non-integer p: no Taylor expansion exists; the engine
        # must raise SANMNumericalError like the reference
        # (libsanm/analytic_unary.cpp:117-120) rather than NaN silently
        # (checkable where x0 is concrete, i.e. the eager engine)
        from sanm_tpu.utils import SANMNumericalError

        x0 = np.array([1.0, 0.0, 2.0])
        tfn = taylor.TaylorFn(lambda x: x**0.5, jnp.asarray(x0))
        eng = tfn.engine()
        eng.start(jnp.asarray(x0))
        with pytest.raises(SANMNumericalError):
            eng.order_bias()
            eng.push(jnp.ones(3))
            eng.order_bias()  # order 2 divides by x0

    def test_log(self):
        xarr = [tensor_rng((5, 4), 1.0, 3.0) for _ in range(4)]
        check_taylor_prop(
            lambda x: jnp.log(x), _zeros_tail(xarr, 4), [0.05, -0.05]
        )

    def test_exp_sqrt(self):
        xarr = [tensor_rng((5, 4), 0.5, 1.5) for _ in range(4)]
        check_taylor_prop(
            lambda x: jnp.exp(x) + jnp.sqrt(x * x + 1.0),
            _zeros_tail(xarr, 4),
            [0.05, -0.05],
        )

    def test_pow_log_pow_composition(self):
        # mirrors Symbolic.GeneralSolve pow-log-pow
        # (tests/symbolic.cpp:595-607)
        xarr = [tensor_rng((10, 20), 1.5, 4.3) for _ in range(4)]
        check_taylor_prop(
            lambda x: jnp.log(x**2.3) ** 1.5,
            _zeros_tail(xarr, 6),
            [0.02, -0.02],
        )

    def test_reduce_and_broadcast(self):
        xarr = [tensor_rng((5, 3, 3), 0.5, 1.5) for _ in range(4)]

        def fn(x):
            ic = jnp.sum(x**2, axis=(1, 2))  # (B,)
            return x * ic[:, None, None]

        check_taylor_prop(fn, _zeros_tail(xarr, 4), [0.03, -0.03])


class TestLinalg:
    def test_matmul(self):
        xarr = [tensor_rng((5, 3, 3), -1, 1) for _ in range(4)]
        check_taylor_prop(
            lambda x: jnp.einsum("bij,bjk->bik", x, x),
            _zeros_tail(xarr, 4),
            [0.05, -0.05],
        )

    def test_det_3x3(self):
        # port of Symbolic determinant Taylor tests
        # (tests/symbolic.cpp:324-360)
        xarr = [tensor_rng((6, 3, 3), -1, 1) for _ in range(5)]
        xarr[0] += 3 * np.eye(3)
        check_taylor_prop(
            batched_det, _zeros_tail(xarr, 5), [0.03, -0.03]
        )

    def test_inv_3x3(self):
        xarr = [tensor_rng((6, 3, 3), -1, 1) for _ in range(4)]
        xarr[0] += 3 * np.eye(3)
        check_taylor_prop(
            batched_inv, _zeros_tail(xarr, 5), [0.02, -0.02]
        )

    @pytest.mark.parametrize("n", [4, 5, 7])
    def test_det_generic_n(self, n):
        # port of the reference determinant Taylor tests up to 7x7
        # (tests/symbolic.cpp:324-360); n > 3 takes the atomic
        # sanm_det primitive (polymat-coefficient bias)
        xarr = [tensor_rng((3, n, n), -1, 1) for _ in range(4)]
        xarr[0] += (n + 1) * np.eye(n)
        check_taylor_prop(
            batched_det, _zeros_tail(xarr, 4), [0.02, -0.02]
        )

    @pytest.mark.parametrize("n", [4, 6])
    def test_inv_generic_n(self, n):
        # generic-n matinv recurrence y_k = -y0 (sum x_i y_{k-i})
        # (reference batched_mat_inv_mul, libsanm/oprs/linalg.cpp:146-197)
        xarr = [tensor_rng((3, n, n), -1, 1) for _ in range(4)]
        xarr[0] += (n + 1) * np.eye(n)
        check_taylor_prop(
            batched_inv, _zeros_tail(xarr, 5), [0.02, -0.02]
        )

    def test_inv_mul_generic_n(self):
        # the reference op is batched_mat_inv_mul (y = x^{-1} a);
        # composition of the matinv primitive with matmul must satisfy
        # the same invariant
        n = 5
        xarr = [tensor_rng((2, n, n), -1, 1) for _ in range(3)]
        xarr[0] += (n + 1) * np.eye(n)

        def fn(x):
            a = jnp.swapaxes(x, -1, -2) + 1.0  # a varying alongside x
            return jnp.einsum(
                "bij,bjk->bik", batched_inv(x), a,
                precision="highest",
            )

        check_taylor_prop(fn, _zeros_tail(xarr, 5), [0.02, -0.02])

    def test_cofactor_generic_n(self):
        # SVD cofactor vs brute-force minors (reference
        # utils/test_cofactor.py:8-36 oracle, generalized to n=5)
        from sanm_tpu.ops.linalg import batched_cofactor_nd

        n = 5
        rng = np.random.default_rng(3)
        x = rng.normal(size=(4, n, n))
        got = np.asarray(batched_cofactor_nd(jnp.asarray(x)))
        want = np.empty_like(x)
        for b in range(x.shape[0]):
            for i in range(n):
                for j in range(n):
                    minor = np.delete(
                        np.delete(x[b], i, axis=0), j, axis=1
                    )
                    want[b, i, j] = ((-1.0) ** (i + j)) * np.linalg.det(
                        minor
                    )
        require_tensor_eq(got, want, 1e-9, msg="cofactor n=5")

    @pytest.mark.slow
    def test_log_det_composite(self):
        # port of Symbolic.LogDetTaylorProp (tests/symbolic.cpp:640-656)
        # y = log(det(x^T x)) for (B, 3, 3)
        xarr = [tensor_rng((10, 3, 3), -1, 1) for _ in range(5)]
        xarr[0] += 3 * np.eye(3)

        def fn(x):
            return jnp.log(batched_det(jnp.einsum("bji,bjk->bik", x, x)))

        check_taylor_prop(fn, _zeros_tail(xarr, 8), [0.01, -0.01])

    def test_mul_eye_combination(self):
        xarr = [tensor_rng((4, 3, 3), -1, 1) for _ in range(4)]
        xarr[0] += 2.5 * np.eye(3)

        def fn(x):
            j = batched_det(x)
            return x * j[:, None, None] ** (-2.0 / 3.0) + batched_mul_eye(
                j * 0.5 - 1.0, 3
            )

        check_taylor_prop(fn, _zeros_tail(xarr, 5), [0.02, -0.02])


class TestSvdW:
    @pytest.mark.slow
    @pytest.mark.parametrize("rot", [False, True])
    def test_polar_decomp_prop(self, rot):
        # port of Symbolic.PolarDecompTaylorProp (tests/symbolic.cpp:658-676).
        # Explicit seeds: the shared tensor_rng stream shifts whenever
        # earlier tests add draws, and the clip_div-regularized affine
        # check is spectrum-sensitive (a shifted stream once drew a
        # clustered spectrum failing 5e-6 at 5e-5); these seeds pass at
        # 5e-7, 10x inside the tolerance, independent of test order.
        batch, n = 7, 3
        xarr = [
            tensor_rng((batch, n, n), -1, 1, seed=4242 + i)
            for i in range(5)
        ]
        xarr[0] = eval_series(xarr, 0.03)

        def fn(x):
            return x - svd_w(x, rot)[2]

        # clip_div regularization makes the affine check slightly
        # basis-dependent for clustered singular values
        check_taylor_prop(
            fn, _zeros_tail(xarr, 16), [0.01, -0.01, 0.02], eps_coeff=5e-6,
            eps_eval=1e-3,
        )

    @pytest.mark.slow
    def test_pw_mode_matches_full_mode(self):
        # polar_w leaves u,s unused -> pw mode; using all outputs -> full
        # mode.  The W series must agree (reference pw_mode switch,
        # libsanm/oprs/linalg.cpp:529-541).
        batch, n = 5, 3
        xarr = [tensor_rng((batch, n, n), -1, 1) for _ in range(4)]
        # well-separated spectrum: the pw/full equivalence is exact in
        # math but the full mode's (s_i - s_j) regularization makes it
        # basis-sensitive when singular values cluster
        xarr[0] = eval_series(xarr, 0.05) + np.diag([2.0, 4.0, 7.0])
        xs = _zeros_tail(xarr, 6)

        def fn_pw(x):
            return x - polar_w(x, True)

        def fn_full(x):
            u, s, w = svd_w(x, True)
            # touch u and s so the full mode is selected
            return (
                x
                - w
                + 0.0 * u
                + 0.0 * jnp.broadcast_to(s[:, None, :], x.shape)
            )

        def run(fn):
            tfn = taylor.TaylorFn(fn, jnp.asarray(xs[0]))

            def full(x0, xks):
                eng = tfn.engine()
                out = [eng.start(x0)]
                for xk in xks:
                    eng.order_bias()
                    yk = eng.push(xk)
                    out.append(
                        jnp.zeros_like(out[0]) if yk is None else yk
                    )
                return jnp.stack(out)

            return np.asarray(
                jax.jit(full)(
                    jnp.asarray(xs[0]), [jnp.asarray(x) for x in xs[1:]]
                )
            )

        for a, b in zip(run(fn_pw), run(fn_full)):
            # agreement is relative to the O(1) coefficient scale; tiny
            # entries accumulate ~1e-10 absolute clip_div noise
            require_tensor_eq(a, b, 1e-5, margin=1e-3, msg="pw vs full")

    def test_svd_w_primal(self):
        m = tensor_rng((20, 3, 3), -1, 1)
        u, s, w = [np.asarray(t) for t in svd_w(jnp.asarray(m), True)]
        # reconstruction
        rec = np.einsum("bij,bj,bkj,bkl->bil", u, s, u, w)
        require_tensor_eq(rec, m, 1e-8, msg="usu^Tw reconstruction")
        # orthogonality
        require_tensor_eq(
            np.einsum("bji,bjk->bik", u, u),
            np.broadcast_to(np.eye(3), (20, 3, 3)),
            1e-8,
            msg="U orthogonal",
        )
        require_tensor_eq(
            np.einsum("bji,bjk->bik", w, w),
            np.broadcast_to(np.eye(3), (20, 3, 3)),
            1e-8,
            msg="W orthogonal",
        )
        detw = np.linalg.det(w)
        require_tensor_eq(detw, np.ones(20), 1e-8, msg="det(W)=1")

    def test_svd_w_primal_reflection(self):
        # matrices with negative determinant still give det(W)=1 under
        # require_rotation (negated singular value)
        m = tensor_rng((16, 3, 3), -1, 1)
        m[: 8] = -m[: 8]
        mdet = np.linalg.det(m)
        u, s, w = [np.asarray(t) for t in svd_w(jnp.asarray(m), True)]
        rec = np.einsum("bij,bj,bkj,bkl->bil", u, s, u, w)
        require_tensor_eq(rec, m, 1e-8, msg="reconstruction")
        require_tensor_eq(
            np.linalg.det(w), np.ones(16), 1e-8, msg="det(W)=1"
        )
        # negative-det matrices must have exactly one negative group
        assert np.all((np.min(s, 1) < 0) == (mdet < 0))

    def test_svd_w_jvp_fd(self):
        # finite-difference check of the analytic JVP (the reference
        # validates the same derivatives with a NumPy oracle,
        # utils/test_svdw_grad.py)
        m = jnp.asarray(tensor_rng((6, 3, 3), -1, 1)) + 2 * jnp.eye(3)
        dm = jnp.asarray(tensor_rng((6, 3, 3), -0.5, 0.5))

        def f(x):
            return svd_w(x, False)

        (u, s, w), (du, ds, dw) = jax.jvp(f, (m,), (dm,))
        eps = 1e-6
        u2, s2, w2 = f(m + eps * dm)
        u1, s1, w1 = f(m - eps * dm)
        require_tensor_eq(
            (np.asarray(s2) - np.asarray(s1)) / (2 * eps),
            np.asarray(ds),
            1e-4,
            msg="ds",
        )
        require_tensor_eq(
            (np.asarray(w2) - np.asarray(w1)) / (2 * eps),
            np.asarray(dw),
            1e-4,
            msg="dw",
        )
        require_tensor_eq(
            (np.asarray(u2) - np.asarray(u1)) / (2 * eps),
            np.asarray(du),
            1e-4,
            msg="du",
        )


class TestPolymat:
    @pytest.mark.parametrize("m", [2, 3, 4])
    @pytest.mark.parametrize("order", [0, 1, 3, 5])
    def test_vs_numpy_bruteforce(self, m, order):
        # port of Tensor.PolyMat (tests/tensor.cpp:500)
        from sanm_tpu.ops.polymat import polymat_det_coeff

        L = 4
        mats = [tensor_rng((3, m, m), -1, 1) for _ in range(L)]
        got = np.asarray(
            polymat_det_coeff([jnp.asarray(x) for x in mats], order)
        )
        # brute force: sample-and-fit via numpy polynomial evaluation
        deg = (L - 1) * m
        a = np.linspace(-1.0, 1.0, deg + 1)
        vals = np.stack(
            [
                np.linalg.det(sum(mats[t] * (ai**t) for t in range(L)))
                for ai in a
            ]
        )  # (deg+1, B)
        V = np.vander(a, deg + 1, increasing=True)
        coeffs = np.linalg.solve(V, vals)  # (deg+1, B)
        want = coeffs[order] if order <= deg else np.zeros(3)
        require_tensor_eq(got, want, 1e-6, msg="polymat coeff")


class TestNumpyEval:
    """numpy_eval must reproduce the jitted graph bit-for-bit (up to
    strict-f64 roundoff) — it is the strict-IEEE residual oracle used by
    the ANM drivers, independent of any backend's compile flags."""

    def _check(self, fn, x, tol=5e-14):
        import jax

        from sanm_tpu.taylor import TaylorFn, numpy_eval

        tfn = TaylorFn(
            fn, jax.ShapeDtypeStruct(x.shape, jnp.float64)
        )
        a = np.asarray(numpy_eval(tfn)(np.asarray(x)))
        b = np.asarray(jax.jit(fn)(jnp.asarray(x)))
        require_tensor_eq(a, b, tol, msg="numpy_eval vs jit")

    def test_elemwise_graph(self):
        x = tensor_rng((4, 5), 0.8, 1.4, seed=11)

        def fn(x):
            return jnp.log(x) * x**3 + jnp.exp(-x) / jnp.sqrt(x) - x**1.5

        self._check(fn, x)

    def test_svd_w_rotation_flip_policy(self):
        # the det(W)=1 flip-group selection must match the device kernel
        # exactly (smallest group, later group wins ties, adjacent-gap
        # grouping) — an O(1) mismatch here poisons the homotopy bias
        from sanm_tpu.ops.svd_w import svd_w

        def fn(x):
            return x - svd_w(x, True)[2]

        self._check(fn, tensor_rng((16, 3, 3), seed=100), 2e-13)
        # near-degenerate spectrum (gap < GROUP_EPS): whole-group flip
        rng = np.random.default_rng(0)
        ms = []
        for _ in range(6):
            q1, _q = np.linalg.qr(rng.standard_normal((3, 3)))
            q2, _q = np.linalg.qr(rng.standard_normal((3, 3)))
            s = np.array([2.0, 2.0 + 2e-4, 0.5])
            ms.append((q1 * s) @ q2.T)
        self._check(fn, np.stack(ms), 2e-13)

    def test_fea_force_graph(self):
        # full elastic-force graph (einsum + svd_w polar + remaps)
        from sanm_tpu.fea import (
            DeformableBody,
            EnergyModel,
            MaterialProperty,
            TetrahedralMesh,
        )

        mesh = TetrahedralMesh.make_cuboid(3, 2, 2, 0.1)
        body = DeformableBody(
            MaterialProperty.from_young_poisson(1e6, 0.4), mesh
        )
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.05, :] = True
        for em in (EnergyModel.ARAP, EnergyModel.NEOHOOKEAN_C):
            model = body.make_forward(em)
            x = model.x0() + tensor_rng(
                model.x0().shape, -0.01, 0.01, seed=5
            )
            f_np = np.asarray(model.eval_force(x))
            import jax

            g = model.lt_inp.remap.apply(jnp.asarray(x))
            f_dev = np.asarray(
                model.lt_out.remap.apply(jax.jit(model.fn)(g))
            ).reshape(-1)
            require_tensor_eq(f_np, f_dev, 1e-9, msg=f"force {em}")


def test_svd3_no_overflow_near_orthogonal():
    """Jacobi rotation must stay finite when the Gram off-diagonal is
    denormal-tiny: the classical tau=(aqq-app)/(2 apq) form overflows
    there, which downstream arithmetic turns into NaN (seen on a few
    rest-state elements of the bar mesh).  The
    overflow-free form keeps exactness on identity-like inputs."""
    import numpy as np
    import jax.numpy as jnp

    from sanm_tpu.ops.svd3 import svd_batched_small

    rng = np.random.default_rng(7)
    # identity + denormal-scale off-diagonal perturbations: apq ~ 1e-308
    ms = np.broadcast_to(np.eye(3), (16, 3, 3)).copy()
    pert = rng.standard_normal((16, 3, 3)) * 1e-308
    ms += pert
    u, s, vh = svd_batched_small(jnp.asarray(ms))
    assert not np.isnan(np.asarray(u)).any()
    assert not np.isnan(np.asarray(s)).any()
    assert not np.isnan(np.asarray(vh)).any()
    recon = np.einsum("bij,bj,bjk->bik", np.asarray(u), np.asarray(s),
                      np.asarray(vh))
    np.testing.assert_allclose(recon, ms, atol=1e-12)

    # regime |d| >> |apq| with denormal apq: well-separated column norms
    # plus 1e-300 off-diagonal coupling.  Here the CLASSICAL tau =
    # (aqq-app)/(2*apq) truly overflows (checked below), which can turn
    # into NaN downstream; the overflow-free form stays exact.
    ms2 = np.broadcast_to(np.diag([2.0, 1.0, 0.5]), (4, 3, 3)).copy()
    ms2 += rng.standard_normal((4, 3, 3)) * 1e-312
    # demonstrate the test hits the overflow regime of the old formula
    a = ms2[0]
    app, aqq = (a[:, 0] ** 2).sum(), (a[:, 1] ** 2).sum()
    apq = (a[:, 0] * a[:, 1]).sum()
    with np.errstate(over="ignore", divide="ignore"):
        assert np.isinf((aqq - app) / (2.0 * apq))
    u2, s2, vh2 = svd_batched_small(jnp.asarray(ms2))
    for arr in (u2, s2, vh2):
        assert np.isfinite(np.asarray(arr)).all()
    np.testing.assert_allclose(
        np.asarray(s2), np.broadcast_to([2.0, 1.0, 0.5], (4, 3)),
        rtol=1e-14,
    )
    recon2 = np.einsum(
        "bij,bj,bjk->bik", np.asarray(u2), np.asarray(s2), np.asarray(vh2)
    )
    np.testing.assert_allclose(recon2, ms2, atol=1e-12)
