"""Classical baseline solvers: projected Newton energy minimization and
Levenberg-Marquardt force equilibrium.

Counterpart of reference ``fea/baseline/*`` (``baseline/main.cpp:228-510``,
eigen-projected per-element Hessians from
``baseline/neohookean_material.cpp:45-247`` / ``arap_material.cpp:63-119``).
These exist for benchmark comparison — the ANM solver is the product.

Device structure: per-element quantities (energy density, PK1, the
9x9 dPsi/dF^2 blocks via basis-tangent ``jax.jvp``, the eigenvalue
projection via batched ``eigh``, and the 12x12 element stiffnesses) are
one jitted batched program; the data-dependent Newton/line-search/
damping control loop runs on the host, with the global solve done by a
dense factorization (host scipy), matching the reference's
PARDISO-backed loop (``baseline/main.cpp:148-183``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import batched_det
from ..ops.svd_w import polar_w
from ..utils import SANMError, Timer, sanm_assert
from .material import EnergyModel, MaterialProperty, pk1


@dataclass
class BaselineStat:
    """Reference ``baseline::Stat`` (``baseline/main.h:11-18``)."""

    nr_iter: int = 0
    nr_iter_refine: int = 0
    tot_time: float = 0.0
    tot_newton_time: float = 0.0
    df: float = 0.0
    dx: float = 0.0
    grad_rms: float = 0.0
    grad_rms_refine: float = 0.0
    energy: float = 0.0
    vtx: Optional[np.ndarray] = None

    def as_json(self):
        """Stat-JSON keys as emitted by the reference
        (``make_baseline_stat``, ``fea/main.cpp:158-170``)."""
        return {
            "iter_tot": self.nr_iter,
            "iter_refine": self.nr_iter_refine,
            "df": self.df,
            "dx": self.dx,
            "force_rms": self.grad_rms,
            "force_rms_refine": self.grad_rms_refine,
            "potential": self.energy,
            "time": self.tot_time,
            "newton_time": self.tot_newton_time,
        }


def material_desc_from_config(config) -> tuple:
    m = config["material"]
    mat = MaterialProperty.from_young_poisson(
        float(m["young"]), float(m["poisson"]), float(m.get("density", 0))
    )
    return EnergyModel.from_name(config["energy_model"]), mat


def _psi(em: EnergyModel, mat: MaterialProperty, F):
    """Energy density per element; consistent with :func:`pk1` (the
    relation P = dPsi/dF is verified by tests/test_fea.py)."""
    mu = mat.shear_modulus
    J = batched_det(F)
    Ic = jnp.sum(F * F, axis=(1, 2))
    if em == EnergyModel.NEOHOOKEAN_C:
        lam = mat.lame_first
        return mu / 2 * (Ic - 3) - mu * jnp.log(J) + lam / 2 * jnp.log(J) ** 2
    if em == EnergyModel.NEOHOOKEAN_I:
        k = mat.bulk_modulus
        return mu / 2 * (J ** (-2.0 / 3.0) * Ic - 3) + k / 2 * (J - 1) ** 2
    if em == EnergyModel.ARAP:
        d = F - polar_w(F, True)
        return mu / 2 * jnp.sum(d * d, axis=(1, 2))
    raise SANMError(f"baseline energy unimplemented for {em}")


class _Kernels:
    """Jitted batched element kernels for one (mesh topology, material)."""

    def __init__(self, tets, rest_vtx, em, mat, hessian_proj,
                 hessian_diag_reg):
        self.tets = np.asarray(tets, np.int64)
        rest_vtx = np.asarray(rest_vtx, np.float64)
        B = self.tets.shape[0]
        x = rest_vtx[self.tets]
        Dm = np.stack(
            [x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]],
            axis=2,
        )
        self.vol = np.abs(np.linalg.det(Dm)) / 6.0
        self.dm_inv = np.linalg.inv(Dm)
        # G[e] = dvec(F)/dx_e: (9, 12); F = Ds Dm^-1,
        # Ds[:, c] = x_{c+1} - x_0
        G = np.zeros((B, 9, 12))
        for r in range(3):
            for j in range(3):
                fi = r * 3 + j
                for m in range(4):
                    if m == 0:
                        G[:, fi, m * 3 + r] = -self.dm_inv[:, :, j].sum(1)
                    else:
                        G[:, fi, m * 3 + r] = self.dm_inv[:, m - 1, j]
        self.G = G
        self.em = em
        self.mat = mat
        self.proj = hessian_proj
        self.diag_reg = hessian_diag_reg

        vol_j = jnp.asarray(self.vol)
        dm_inv_j = jnp.asarray(self.dm_inv)
        G_j = jnp.asarray(G)
        tets_j = jnp.asarray(self.tets)

        def deform_grad(vtx):
            xe = vtx[tets_j]  # (B, 4, 3)
            ds = jnp.stack(
                [xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0],
                 xe[:, 3] - xe[:, 0]],
                axis=2,
            )
            return jnp.einsum(
                "bij,bjk->bik", ds, dm_inv_j, precision="highest"
            )

        def energy(vtx):
            return jnp.sum(_psi(em, mat, deform_grad(vtx)) * vol_j)

        def forces(vtx):
            """-dE/dx as (V, 3)."""
            return -jax.grad(energy)(vtx)

        def dpdf_blocks(vtx):
            """Per-element 9x9 dP/dF blocks via basis-tangent JVPs."""
            F = deform_grad(vtx)

            def pk1_of(Fv):
                return pk1(em, mat, Fv, 3)

            cols = []
            eye = jnp.eye(9, dtype=vtx.dtype)
            for q in range(9):
                tan = jnp.broadcast_to(eye[q].reshape(1, 3, 3), F.shape)
                _, jv = jax.jvp(pk1_of, (F,), (tan,))
                cols.append(jv.reshape(F.shape[0], 9))
            return jnp.stack(cols, axis=2)  # (B, 9, 9)

        def assemble_k(dPdF):
            K = jnp.einsum(
                "bfi,bfg,bgj,b->bij", G_j, dPdF, G_j, vol_j,
                precision="highest",
            )
            if self.diag_reg:
                K = K + self.diag_reg * jnp.eye(12, dtype=K.dtype)
            return K

        # hoisted jit: G (B,9,12) alone is ~36 MB f64 at 42k tets and
        # would otherwise be an embedded XLA constant in each executable
        from ..jit_util import jit_hoist_consts

        self._dpdf_blocks = jit_hoist_consts(dpdf_blocks)
        self._assemble_k = jit_hoist_consts(assemble_k)
        self.energy = jit_hoist_consts(energy)
        self.forces = jit_hoist_consts(forces)

    def hess_blocks(self, vtx):
        """Per-element 12x12 energy Hessian blocks, optionally
        eigen-projected (reference g_hessian_proj toggle,
        ``baseline/neohookean_material.cpp:160-247``).

        The 9x9 dP/dF JVP sweep and the G^T dPdF G contraction run on
        the device; the eigen-projection runs in host NumPy (LAPACK
        ``eigh`` on the 9x9 blocks), which stays finite on the
        near-degenerate rest-state spectra.  Whether a device ``eigh``
        is accurate and faster there is not measured yet."""
        dPdF = self._dpdf_blocks(vtx)
        if self.proj:
            d = np.asarray(dPdF)
            if not np.isfinite(d).all():
                # inverted elements (J <= 0) make log(J)/J^(-2/3) NaN;
                # the reference baseline materials throw the same way
                # (``baseline/neohookean_material.cpp:15-16,128-129``)
                from ..utils import SANMNumericalError

                raise SANMNumericalError(
                    "non-finite element Hessian (J <= 0 in %s): the "
                    "Newton baseline, like the reference's, cannot "
                    "start from a configuration with inverted elements"
                    % self.em
                )
            d = 0.5 * (d + np.swapaxes(d, 1, 2))
            w, v = np.linalg.eigh(d)
            w = np.maximum(w, 0.0)
            dPdF = jnp.asarray(np.einsum("bik,bk,bjk->bij", v, w, v))
        return self._assemble_k(dPdF)


_SPARSE_THRESHOLD = 3000  # dofs beyond which scipy.sparse is used


def _assemble_dense_hessian(blocks, tets, nV):
    """Scatter (B, 12, 12) element blocks into a dense (3V, 3V) matrix."""
    H = np.zeros((3 * nV, 3 * nV))
    idx = (tets[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(
        -1, 12
    )  # (B, 12) global dof indices
    np.add.at(
        H,
        (idx[:, :, None], idx[:, None, :]),
        np.asarray(blocks),
    )
    return H


def _assemble_hessian(blocks, tets, nV, free_flat):
    """Assemble element blocks and restrict to free dofs; returns a dense
    ndarray for small systems and a scipy CSR matrix for large ones (the
    reference always uses sparse PARDISO; we pick by size)."""
    n = 3 * nV
    if n <= _SPARSE_THRESHOLD:
        H = _assemble_dense_hessian(blocks, tets, nV)
        return H[np.ix_(free_flat, free_flat)]
    import scipy.sparse as sp

    idx = (tets[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(
        -1, 12
    )
    rows = np.repeat(idx, 12, axis=1).reshape(-1)
    cols = np.tile(idx, (1, 12)).reshape(-1)
    H = sp.coo_matrix(
        (np.asarray(blocks).reshape(-1), (rows, cols)), shape=(n, n)
    ).tocsr()
    keep = np.nonzero(free_flat)[0]
    return H[keep][:, keep]


def _solve_dense(H, rhs, spd):
    import scipy.linalg as sla
    import scipy.sparse as sp

    if sp.issparse(H):
        import scipy.sparse.linalg as spla

        return spla.splu(
            H.tocsc()
        ).solve(rhs)
    if spd:
        try:
            c = sla.cho_factor(H)
            return sla.cho_solve(c, rhs)
        except np.linalg.LinAlgError:
            pass
    return sla.solve(H, rhs)


def check_hessian_fd(kern: "_Kernels", vtx, eps=1e-6, samples=8, seed=0):
    """Finite-difference validation of the (unprojected) element-Hessian
    assembly against the force: H u ~= -(f(v+eps u) - f(v-eps u))/(2 eps).

    Counterpart of the reference's env-gated FD Hessian checker
    (``fea/baseline/hcheck.cpp:6-77``, enabled by FEA_CHECK,
    ``baseline/main.cpp:130-146``)."""
    was_proj = kern.proj
    kern.proj = False
    try:
        nV = vtx.shape[0]
        H = _assemble_dense_hessian(
            kern.hess_blocks(jnp.asarray(vtx)), kern.tets, nV
        )
        rng = np.random.default_rng(seed)
        worst = 0.0
        for _ in range(samples):
            u = rng.standard_normal(nV * 3)
            u /= np.linalg.norm(u)
            fp = np.asarray(
                kern.forces(jnp.asarray(vtx + eps * u.reshape(nV, 3)))
            ).reshape(-1)
            fm = np.asarray(
                kern.forces(jnp.asarray(vtx - eps * u.reshape(nV, 3)))
            ).reshape(-1)
            fd = -(fp - fm) / (2 * eps)
            hu = H @ u
            err = np.linalg.norm(fd - hu) / max(np.linalg.norm(hu), 1e-30)
            worst = max(worst, err)
        if worst > 1e-4:
            raise SANMError(
                "FD Hessian check failed: rel err %g" % worst
            )
        return worst
    finally:
        kern.proj = was_proj


def solve_energy_min(
    elements,
    vtx_init,
    vtx_dst,
    f_ext,
    bnd_mask,
    material_desc,
    gtol_refine,
    iter_callback=None,
    hessian_proj=True,
    hessian_diag_reg=0.0,
) -> BaselineStat:
    """Projected Newton with backtracking line search + unprojected
    refinement (reference ``baseline::solve_energy_min``,
    ``baseline/main.cpp:228-390``)."""
    em, mat = material_desc
    tets = np.asarray(elements, np.int64)
    vtx_init = np.asarray(vtx_init, np.float64)
    nV = vtx_init.shape[0]
    free = ~np.asarray(bnd_mask, bool).reshape(nV, 3)
    free_flat = free.reshape(-1)
    kern = _Kernels(tets, vtx_init, em, mat, hessian_proj, hessian_diag_reg)

    f_ext_flat = (
        None if f_ext is None else np.asarray(f_ext).reshape(-1)
    )

    def total_energy(v):
        e = float(kern.energy(jnp.asarray(v)))
        if f_ext_flat is not None:
            e += float(
                (vtx_init.reshape(-1) - v.reshape(-1)) @ f_ext_flat
            )
        return e

    def grad_free(v):
        """force (= -dE/dx) on free coords."""
        f = np.asarray(kern.forces(jnp.asarray(v))).reshape(-1)
        if f_ext_flat is not None:
            f = f + f_ext_flat
        return f[free_flat]

    def hess_free(v, proj):
        kern.proj = proj
        return _assemble_hessian(
            kern.hess_blocks(jnp.asarray(v)), tets, nV, free_flat
        )

    import os

    if os.environ.get("FEA_CHECK"):
        # FD Hessian validation, gated like the reference
        # (baseline/main.cpp:130-146)
        err = check_hessian_fd(kern, np.asarray(vtx_dst, np.float64))
        print("FEA_CHECK hessian FD rel err: %g" % err)

    vertices = np.asarray(vtx_dst, np.float64).copy()
    stat = BaselineStat()
    timer = Timer().start()
    newton_timer = Timer()
    gtol, xtol, ls_c1 = 1e-6, 1e-6, 0.2

    while True:
        grad = grad_free(vertices)
        H = hess_free(vertices, hessian_proj)
        stat.nr_iter += 1
        newton_timer.start()
        u = _solve_dense(H, grad, spd=hessian_proj)
        step = 1.0
        energy = total_energy(vertices)
        c1_g_p = -ls_c1 * float(u @ grad)
        dx_base = float(np.linalg.norm(u)) / (
            float(np.linalg.norm(vertices)) + 1.0
        )
        if hessian_proj:
            sanm_assert(c1_g_p < 0, "not a descent direction")
        else:
            c1_g_p = min(c1_g_p, 0.0)
        new_vertices = vertices
        while True:
            new_vertices = vertices.copy()
            nv = new_vertices.reshape(-1)
            nv[free_flat] += u * step
            new_energy = total_energy(new_vertices)
            if new_energy < energy + step * c1_g_p:
                break
            step /= 2
            if dx_base * step < xtol:
                new_vertices = vertices
                new_energy = energy
                break
        newton_timer.stop()
        stat.tot_newton_time = newton_timer.time()
        grad_rms = float(np.sqrt(np.mean(grad * grad)))
        df = (energy - new_energy) / (new_energy + 1)
        dx = dx_base * step
        vertices = new_vertices
        if iter_callback and not iter_callback(vertices):
            break
        if grad_rms < gtol or dx < xtol:
            stat.df = df
            stat.dx = dx
            stat.grad_rms = grad_rms
            stat.energy = energy
            break

    if stat.grad_rms > gtol_refine:
        # unprojected Newton refinement (baseline/main.cpp:355-388)
        while True:
            grad = grad_free(vertices)
            grad_rms = float(np.sqrt(np.mean(grad * grad)))
            if grad_rms < gtol_refine or stat.nr_iter_refine >= 20:
                stat.grad_rms_refine = grad_rms
                break
            H = hess_free(vertices, False)
            stat.nr_iter += 1
            stat.nr_iter_refine += 1
            newton_timer.start()
            u = _solve_dense(H, grad, spd=False)
            v = vertices.reshape(-1)
            v[free_flat] += u
            newton_timer.stop()
            stat.tot_newton_time = newton_timer.time()
            if iter_callback and not iter_callback(vertices):
                break

    stat.tot_time = timer.stop().time()
    stat.vtx = vertices
    return stat


def solve_force_equ_levmar(
    elements,
    vtx_init,
    f_ext,
    bnd_mask,
    material_desc,
    gtol,
    iter_callback=None,
    hessian_diag_reg=0.0,
) -> BaselineStat:
    """Levenberg-Marquardt on the force residual (reference
    ``baseline::solve_force_equ_levmar``, ``baseline/main.cpp:392-510``):
    solve (H^T H with damped diagonal) delta = H^T f, adaptive damping."""
    em, mat = material_desc
    tets = np.asarray(elements, np.int64)
    vtx_init = np.asarray(vtx_init, np.float64)
    nV = vtx_init.shape[0]
    free = ~np.asarray(bnd_mask, bool).reshape(nV, 3)
    free_flat = free.reshape(-1)
    kern = _Kernels(tets, vtx_init, em, mat, False, hessian_diag_reg)
    f_ext_flat = np.asarray(f_ext).reshape(-1)

    def force_free(v):
        f = np.asarray(kern.forces(jnp.asarray(v))).reshape(-1)
        return (f + f_ext_flat)[free_flat]

    def hess_free(v):
        return _assemble_hessian(
            kern.hess_blocks(jnp.asarray(v)), tets, nV, free_flat
        )

    vertices = vtx_init.copy()
    stat = BaselineStat()
    timer = Timer().start()
    newton_timer = Timer()
    damp = 1e-4
    damp_k = 10.0
    damp_min = np.finfo(np.float64).eps
    max_iters = 1000

    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    while True:
        stat.nr_iter += 1
        force = force_free(vertices)
        H = hess_free(vertices)
        newton_timer.start()
        energy = float(np.sqrt(np.mean(force * force)))
        # Above _SPARSE_THRESHOLD dofs _assemble_hessian returns CSR; the
        # damped normal equations then stay sparse end-to-end (the
        # reference always solves them with PardisoLLT on the sparse A'A,
        # baseline/main.cpp:186-220,392-510).
        sparse = sp.issparse(H)
        HtH = (H.T @ H).tocsr() if sparse else H.T @ H
        rhs = H.T @ force
        diag = HtH.diagonal().copy() if sparse else np.diag(HtH).copy()
        search_cnt = 0
        while True:
            search_cnt += 1
            damped = HtH.copy()
            if sparse:
                damped.setdiag(diag * (1 + damp))
                try:
                    delta = spla.splu(damped.tocsc()).solve(rhs)
                except RuntimeError:
                    # singular damped normal matrix: treat like a
                    # rejected trial step so the damping search raises
                    # damp (the dense branch's LinAlgError analog)
                    damp *= damp_k
                    if search_cnt >= 50:
                        stat.grad_rms = energy
                        stat.dx = -1
                        stat.tot_time = timer.stop().time()
                        stat.vtx = vertices
                        return stat
                    continue
            else:
                np.fill_diagonal(damped, diag * (1 + damp))
                try:
                    delta = sla.solve(damped, rhs, assume_a="pos")
                except np.linalg.LinAlgError:
                    delta = sla.solve(damped, rhs)
            new_vertices = vertices.copy()
            nv = new_vertices.reshape(-1)
            nv[free_flat] += delta
            try:
                nf = force_free(new_vertices)
                new_energy = float(np.sqrt(np.mean(nf * nf)))
                if not np.isfinite(new_energy):
                    new_energy = energy * 1.1
            except FloatingPointError:
                new_energy = energy * 1.1
            if new_energy < energy:
                damp = max(damp / damp_k, damp_min)
                break
            damp *= damp_k
            if search_cnt >= 50:
                stat.grad_rms = energy
                stat.dx = -1
                stat.tot_time = timer.stop().time()
                stat.vtx = vertices
                return stat
        newton_timer.stop()
        stat.tot_newton_time = newton_timer.time()
        dx = float(np.linalg.norm(delta)) / (
            float(np.linalg.norm(new_vertices)) + 1.0
        )
        vertices = new_vertices
        energy = new_energy
        if iter_callback and not iter_callback(vertices):
            break
        if energy < gtol or stat.nr_iter >= max_iters:
            stat.dx = dx
            stat.grad_rms = energy
            break

    stat.tot_time = timer.stop().time()
    stat.vtx = vertices
    return stat


def run_from_config(config, deformable, f_load_full, thresh) -> BaselineStat:
    """Dispatch per the ``baseline`` config section (reference
    ``setup_baseline`` + the baseline branch of ``run_and_save``,
    ``fea/main.cpp:123-133,343-379``)."""
    bc = config["baseline"]
    proj = not bc.get("hessian_no_proj", False)
    reg = float(bc.get("hessian_diag", 0.0))
    desc = material_desc_from_config(config)
    print(": using baseline: proj=%d reg=%g" % (proj, reg))
    if bc.get("use_levmar", False):
        print("opt: levmar")
        return solve_force_equ_levmar(
            deformable.mesh.tets,
            deformable.mesh.vertices,
            f_load_full,
            deformable.coord_fixed_mask,
            desc,
            thresh,
            hessian_diag_reg=reg,
        )
    return solve_energy_min(
        deformable.mesh.tets,
        deformable.mesh.vertices,
        deformable.mesh.vertices,
        f_load_full,
        deformable.coord_fixed_mask,
        desc,
        thresh,
        hessian_proj=proj,
        hessian_diag_reg=reg,
    )
