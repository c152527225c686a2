"""FEA application: tasks, config layering, solver loops, stat JSON.

Counterpart of reference ``fea/main.cpp``: the CLI
``python -m sanm_tpu.fea <sys.json> <task.json> [override.json ...]``
accepts the reference's config corpus unmodified (``config/*.json``) —
positional JSON files merged left to right (``fea/main.cpp:1074-1079``),
task dispatch on ``func`` (``:1080-1101``), the same task functions
(``test_single_tet_inverse``, ``test_cuboid``, ``test_cuboid_twist``,
``gravity``, ``mesh_twist``), per-run stat JSON with the same keys, and
OBJ outputs.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np

from ..solver import ANMEqnSolver, ANMImplicitSolver, ANMSolverVecScale
from ..solver.anm import EqnHyperParam, HyperParam
from ..utils import SANMError, ScopedProfiler, Timer, sanm_assert
from .material import EnergyModel, MaterialProperty
from .mesh import TetrahedralMesh
from .model import DeformableBody

#: convergence target used by the paper benchmarks
#: (reference ``fea/main.cpp:28``)
RMS_THRESH_FORCE_EQU = 1e-10

def _null_ctx():
    import contextlib

    return contextlib.nullcontext()


def _warm_repeat_count():
    """Number of warm re-solves under ``SANM_WARM_TIMING``.

    ``SANM_WARM_TIMING=1`` (or any non-integer truthy value) runs a
    single re-solve; ``=N`` runs N and the caller reports the minimum
    and every sample."""
    v = os.environ.get("SANM_WARM_TIMING", "")
    try:
        return max(1, int(v))
    except ValueError:
        return 1


_total_nr_iter = [0]
# cumulative solver wall time (time_solve / continuation "time" entries)
# across task-internal solves; lets warm-rerun wrappers report the
# solver-only portion of a re-run (see _with_warm_rerun)
_total_solve_time = [0.0]


# ----------------------------------------------------------------------------
# config helpers (reference fea/main.cpp:90-150)
# ----------------------------------------------------------------------------


def read_json(path):
    with open(path) as f:
        return json.load(f)


def merge_configs(paths):
    cfg = read_json(paths[0])
    for p in paths[1:]:
        cfg.update(read_json(p))
    return cfg


def make_material_property(mconf, need_density=False) -> MaterialProperty:
    sanm_assert(mconf["type"] == "young_poisson", "unknown material type")
    density = float(mconf.get("density", 0.0))
    if need_density:
        sanm_assert("density" in mconf, "density required")
    return MaterialProperty.from_young_poisson(
        float(mconf["young"]), float(mconf["poisson"]), density
    )


def setup_solver_param(config, eqn=False):
    """Reference ``setup_solver_param`` (``fea/main.cpp:105-119``)."""
    hp = EqnHyperParam() if eqn else HyperParam()
    hp.order = int(config.get("order", 20))
    hp.xcoeff_l2_penalty = float(config.get("xcoeff_l2_penalty", 0.0))
    hp.use_pade = not config.get("disable_pade", False)
    hp.sanity_check = not config.get("disable_anm_sanity_check", False)
    # SANM_SOLVER env overrides the config (experiment harness knob,
    # like the reference's SANM_PADE toggle, libsanm/anm.cpp:142)
    hp.solver = os.environ.get("SANM_SOLVER", config.get("solver", "auto"))
    if eqn:
        hp.converge_rms = RMS_THRESH_FORCE_EQU
    return hp


def energy_model_of(config) -> EnergyModel:
    return EnergyModel.from_name(config["energy_model"])


def save_json(path, stat):
    with open(path, "w") as f:
        json.dump(stat, f, indent=4)
        f.write("\n")


# ----------------------------------------------------------------------------
# solver loops (reference run_anm, fea/main.cpp:172-215)
# ----------------------------------------------------------------------------


def run_anm_eqn(solver: ANMEqnSolver, progress=True):
    it = 0
    while not solver.converged():
        if progress:
            print(" %.2g" % solver.residual_rms(), end="", flush=True)
        solver.next_iter()
        it += 1
        if it > 10000:
            raise SANMError("ANM did not converge")
    it = solver.get_nr_iter()
    _total_nr_iter[0] += it
    if progress:
        print(" iter=%d" % it)
    return solver.get_x()


def run_anm_implicit(
    solver: ANMImplicitSolver, t_dest=1.0, callback=None, progress=True
):
    it = 0
    while True:
        if progress:
            print(" %.2g" % solver.get_t_upper(), end="", flush=True)
        if callback:
            callback(solver)
        if solver.get_t_upper() >= t_dest:
            break
        solver.update_approx()
        it += 1
        if it > 10000:
            raise SANMError("implicit continuation stalled")
    _total_nr_iter[0] += solver.get_nr_iter()
    if progress:
        print(" iter=%d" % solver.get_nr_iter())
    return solver.eval(solver.solve_a(t_dest))[0]


# ----------------------------------------------------------------------------
# measurement helpers (reference fea/main.cpp:219-244)
# ----------------------------------------------------------------------------


class TaskResult:
    """Uniform task return value: the deformed mesh + the stat dict that
    is also written next to the output OBJ (reference stat emission,
    ``fea/main.cpp:276-296``).  Every entry of :data:`TASKS` returns one,
    so harnesses (bench.py, chip_smoke.py) consume stats from the return
    value instead of re-reading them off disk.  ``solver`` is the ANM
    driver of an equilibrium solve (None for the baselines and the
    continuation tasks)."""

    def __init__(self, mesh, stat, solver=None):
        self.mesh = mesh
        self.stat = stat
        self.solver = solver


def relative_displacement(v0, v1):
    v0 = np.asarray(v0)
    v1 = np.asarray(v1)
    vmin = v0.min(axis=0)
    vmax = v0.max(axis=0)
    d = np.sqrt(((v1 - v0) ** 2).sum() / v0.size)
    return float(d / np.linalg.norm(vmax - vmin))


def get_nr_inverted(tets, v0, v1):
    def signs(v):
        x = v[tets]
        det = np.einsum(
            "ti,ti->t",
            x[:, 1] - x[:, 0],
            np.cross(x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]),
        )
        return det >= 0

    return int((signs(np.asarray(v0)) != signs(np.asarray(v1))).sum())


# ----------------------------------------------------------------------------
# equilibrium solve (reference run_and_save, fea/main.cpp:247-433)
# ----------------------------------------------------------------------------


def run_and_save(
    name,
    config,
    deformable: DeformableBody,
    inverse_mode: bool,
    f_load_full,
    save=True,
    allow_invcheck=True,
    progress=True,
):
    if progress:
        print("solving %s%s " % (name, " (inv)" if inverse_mode else ""),
              end="", flush=True)
    jstat = {}
    timer = Timer().start()

    em = energy_model_of(config)
    model = (
        deformable.make_inverse(em)
        if inverse_mode
        else deformable.make_forward(em)
    )
    f_load_sub = model.lt_inp.copy_vtx_values(f_load_full)
    jstat["time_prep"] = timer.stop().time()

    if config.get("baseline") is not None:
        from . import baseline

        sanm_assert(not inverse_mode)
        stat = baseline.run_from_config(
            config, deformable, f_load_full, RMS_THRESH_FORCE_EQU
        )
        if os.environ.get("SANM_WARM_TIMING"):
            # re-run with compiled kernels in-process: reported times
            # then exclude XLA compilation / cache-deserialization, the
            # analog of the reference timing a long-lived process
            t = Timer().start()
            stat = baseline.run_from_config(
                config, deformable, f_load_full, RMS_THRESH_FORCE_EQU
            )
            jstat["time_solve_warm"] = t.stop().time()
        for k, v in stat.as_json().items():
            jstat[k] = v
        xt = model.lt_inp.copy_vtx_values(stat.vtx)
        solution_sanity_check = not config["baseline"].get(
            "use_levmar", False
        )
        return _post_process(
            name, config, deformable, model, xt, f_load_sub, f_load_full,
            jstat, inverse_mode, save, allow_invcheck,
            solution_sanity_check, progress,
        )

    iter_begin = _total_nr_iter[0]
    timer.reset().start()
    hp = setup_solver_param(config, eqn=True)
    hp.solution_check_tol = 1e-3

    need_save_interm = bool(config.get("save_interm", False))
    if need_save_interm:
        # continuation snapshots without error correction
        # (reference fea/main.cpp:388-414)
        hp.solution_check_tol = 0.01
        solver = ANMSolverVecScale(
            model.fn, model.lt_inp.remap, model.lt_out.remap,
            model.x0(), 0.0, f_load_sub, hp,
        )
        tnext = 0.05
        xt = model.x0()
        it = 1
        while tnext < 1:
            while tnext <= 1.02 and solver.get_t_upper() >= tnext:
                xt = solver.eval(solver.solve_a(tnext))[0]
                _save_interm(config, deformable, model, xt, f_load_sub,
                             "%.2f" % tnext, it, timer)
                tnext += 0.05
            if tnext >= 1:
                break
            solver.update_approx()
            it += 1
    else:
        if progress:
            print("order=%d:" % hp.order, end="", flush=True)
        solver = ANMEqnSolver(
            model.fn, model.lt_inp.remap, model.lt_out.remap,
            model.x0(), f_load_sub, hp,
        )
        xt = run_anm_eqn(solver, progress)

    jstat["time_solve"] = timer.stop().time()
    _total_solve_time[0] += jstat["time_solve"]
    jstat["iter"] = _total_nr_iter[0] - iter_begin
    if (
        os.environ.get("SANM_WARM_TIMING")
        and config.get("baseline") is None
        and not need_save_interm
    ):
        # warm re-solve reusing compiled kernels and the host assembler
        # (a long-lived production solver), excluding XLA compilation /
        # cache-deserialization and host topology setup.
        # SANM_WARM_TIMING=N (N>=2) runs N re-solves and reports the
        # best and every sample.
        # SANM_COMPILE_GUARD: hot-loop discipline tripwire (the XLA
        # analog of the reference's Eigen no-malloc guard,
        # libsanm/tensor_impl_helper.h:12,45-64) — a warm re-solve that
        # recompiles is a hot-loop performance bug.  "warn" prints,
        # anything else truthy raises.  The count is always recorded
        # as warm_compiles.
        from ..utils import compile_count, compile_guard

        cg_mode = os.environ.get("SANM_COMPILE_GUARD", "")
        # any _cold_warm background compile threads must finish before
        # the clock starts: a straggler compile would steal host cores
        # from the timed re-solve
        getattr(solver, "join_warm_threads", lambda: None)()
        compiles0 = compile_count()
        runs = []
        for _ in range(_warm_repeat_count()):
            sp0 = ScopedProfiler.total(
                "sparse_prep"
            ) + ScopedProfiler.total("sparse_solve")
            t = Timer().start()
            with compile_guard(
                warn_only=(cg_mode == "warn"), tag="warm re-solve"
            ) if cg_mode else _null_ctx():
                solver.reset()
                xt = run_anm_eqn(solver, progress=False)
            tw = t.stop().time()
            sp1 = ScopedProfiler.total(
                "sparse_prep"
            ) + ScopedProfiler.total("sparse_solve")
            runs.append((tw, (sp1 - sp0) / tw if sp1 > sp0 else None))
        jstat["warm_compiles"] = compile_count() - compiles0
        best = min(runs, key=lambda r: r[0])
        jstat["time_solve_warm"] = best[0]
        jstat["warm_samples"] = [round(r[0], 4) for r in runs]
        if best[1] is not None:
            # share of the warm solve spent in the sparse solver —
            # measured over the warm re-solve ONLY, matching the
            # reference's time_solve denominator
            # (render/gen_table_figs.py:328-339)
            jstat["sparse_share_warm"] = best[1]
    jstat["order"] = hp.order
    jstat["name"] = name
    jstat["pade"] = hp.use_pade
    jstat["pade_log"] = getattr(solver, "pade_log", [])
    # device count stands in for the reference's thread counts
    # (fea/main.cpp:428-429); SPMD replaces intra-process threading
    import jax

    # "threads" keeps the reference stat-JSON key (fea/main.cpp:276-296)
    # but counts accelerator devices, NOT CPU threads — comparisons
    # against reference logs must not read it as a thread count
    # (threads_semantics makes the unit machine-checkable).
    jstat["threads"] = jax.device_count()
    jstat["solver_threads"] = jax.device_count()
    jstat["threads_semantics"] = "jax_device_count"
    jstat["solver_backend"] = hp.solver
    jstat["solver_resolved"] = solver._solver_mode()
    jstat["loop_resolved"] = solver._loop_mode()
    jstat["loop_mode"] = hp.loop
    res = _post_process(
        name, config, deformable, model, xt, f_load_sub, f_load_full,
        jstat, inverse_mode, save, allow_invcheck, True, progress,
    )
    res.solver = solver
    return res


def _save_interm(config, deformable, model, xt, f_load_sub, suffix, it,
                 timer):
    timer.stop()
    out_name = config["out_filename"] + "-" + suffix + ".obj"
    mesh = deformable.mesh.copy()
    mesh.replace_with_mask(deformable.coord_fixed_mask, xt)
    mesh.write_obj(out_name)
    save_json(out_name + ".json", {
        "time": timer.time(),
        "iter": it,
        "rms": DeformableBody.compute_force_rms(model, xt, f_load_sub),
    })
    timer.start()
    return timer.time()


def _post_process(
    name, config, deformable, model, xt, f_load_sub, f_load_full, jstat,
    inverse_mode, save, allow_invcheck, solution_sanity_check, progress,
):
    out_mesh = deformable.mesh.copy()
    out_mesh.replace_with_mask(deformable.coord_fixed_mask, xt)

    jstat["force_rms_recomp"] = DeformableBody.compute_force_rms(
        model, xt, f_load_sub, out_mesh, solution_sanity_check
    )
    jstat["mesh_V"] = deformable.mesh.nr_vertices
    jstat["mesh_F"] = deformable.mesh.nr_tet
    jstat["displacement"] = relative_displacement(
        deformable.mesh.vertices, out_mesh.vertices
    )
    jstat["nr_inverted"] = get_nr_inverted(
        deformable.mesh.tets, deformable.mesh.vertices, out_mesh.vertices
    )
    if save:
        out = config["out_filename"]
        deformable.mesh.write_obj(out + "-orig.obj")
        out += "-i%d-%s" % (int(inverse_mode), config["energy_model"])
        out_mesh.write_obj(out + ".obj")
        save_json(out + ".json", jstat)
        if "out_surface_vtx" in config:
            out_mesh.write_surface_vtx(config["out_surface_vtx"])

    if allow_invcheck and os.environ.get("FEA_INVCHECK"):
        # forward/inverse round-trip check (reference fea/main.cpp:299-310)
        inv_body = DeformableBody(deformable.material, out_mesh)
        inv_body.coord_fixed_mask = deformable.coord_fixed_mask
        restored = run_and_save(
            name + " invcheck", config, inv_body, not inverse_mode,
            f_load_full, save=False, allow_invcheck=False,
            progress=progress,
        )
        norm = float(
            np.linalg.norm(restored.mesh.vertices - deformable.mesh.vertices)
        )
        print("invcheck norm: %g" % norm)
    return TaskResult(out_mesh, jstat)


# ----------------------------------------------------------------------------
# prescribed-displacement continuation
# (reference run_with_vtx_delta, fea/main.cpp:436-582)
# ----------------------------------------------------------------------------


def run_with_vtx_delta(
    name,
    config,
    deformable: DeformableBody,
    vtx_delta,
    vtx_coord,  # updated in place (numpy (V,3))
    require_refine: bool,
    refine_f_load=None,
    progress=True,
):
    if progress:
        print("solving %s(delta) " % name, end="", flush=True)
    jstat = {}
    timer = Timer().start()
    vtx_dst_boundary = deformable.mesh.vertices + vtx_delta
    mask = deformable.coord_fixed_mask

    def enforce_dst_boundary():
        vtx_coord[mask] = vtx_dst_boundary[mask]

    em = energy_model_of(config)
    model = deformable.make_forward(em, vtx_coord, vtx_delta)

    def eval_force_rms():
        m = deformable.make_forward(em, vtx_coord)
        f = np.asarray(m.eval_force(m.x0()))
        return float(np.sqrt(np.mean(f * f)))

    def eval_potential():
        m = deformable.make_forward(em, vtx_coord)
        p = m.eval_potential(m.x0())
        return -1.0 if p is None else float(p)

    iter_begin = _total_nr_iter[0]

    if config.get("baseline") is not None:
        from . import baseline

        stat = baseline.solve_energy_min(
            deformable.mesh.tets, deformable.mesh.vertices,
            vtx_dst_boundary, None, mask,
            baseline.material_desc_from_config(config),
            RMS_THRESH_FORCE_EQU,
        )
        vtx_coord[:] = stat.vtx
        enforce_dst_boundary()
        _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                     eval_potential)
        for k, v in stat.as_json().items():
            jstat[k] = v
        return jstat

    time_prep = timer.stop().time()
    timer.reset().start()
    hp = setup_solver_param(config)
    hp.solution_check_tol = 10.0  # high tolerance (fea/main.cpp:513)
    if progress:
        print("order=%d:" % hp.order, end="", flush=True)
    solver = ANMImplicitSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(), 0.0,
        hp,
    )

    callback = None
    if config.get("save_interm", False):
        state = {"tnext": 0.0}

        def callback(s):
            while state["tnext"] <= 1 and s.get_t_upper() >= state["tnext"]:
                xt = s.eval(s.solve_a(state["tnext"]))[0]
                mesh = TetrahedralMesh(
                    vtx_coord, deformable.mesh.tets,
                    deformable.mesh.surface_vtx, deformable.mesh.surfaces,
                )
                mesh.replace_with_mask(mask, xt)
                mesh.apply_vtx_delta(vtx_delta * state["tnext"])
                mesh.write_obj(
                    "%s-%.2f.obj" % (config["out_filename"], state["tnext"])
                )
                state["tnext"] += 0.1

    xt = run_anm_implicit(solver, 1.0, callback, progress)
    timer.stop()
    if progress:
        print("timing(sec): prep=%.3f solve=%.3f" % (time_prep, timer.time()))
    vtx_coord[~mask] = np.asarray(xt).reshape(-1)
    vtx_coord += vtx_delta

    force_rms = eval_force_rms()
    if progress:
        print("force rms: %g" % force_rms)
    require_refine = require_refine or force_rms >= RMS_THRESH_FORCE_EQU
    iters_before_refine = _total_nr_iter[0]

    if require_refine:
        # low-order error-correcting refinement (fea/main.cpp:554-574)
        model2 = deformable.make_forward(em, vtx_coord)
        if refine_f_load is not None:
            f_load_sub = model2.lt_inp.copy_vtx_values(refine_f_load)
        else:
            f_load_sub = np.zeros(model2.lt_inp.n_unknown_vtx)
        hp2 = setup_solver_param(config, eqn=True)
        hp2.order = 6
        timer.start()
        rsolver = ANMEqnSolver(
            model2.fn, model2.lt_inp.remap, model2.lt_out.remap,
            model2.x0(), f_load_sub, hp2,
        )
        if progress:
            print("refine %s:" % name, end="", flush=True)
        xt = run_anm_eqn(rsolver, progress)
        timer.stop()
        vtx_coord[~mask] = np.asarray(xt).reshape(-1)

    enforce_dst_boundary()
    _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                 eval_potential)
    jstat["iter_tot"] = _total_nr_iter[0] - iter_begin
    jstat["iter_deform"] = iters_before_refine - iter_begin
    jstat["iter_refine"] = _total_nr_iter[0] - iters_before_refine
    jstat["time"] = timer.time()
    _total_solve_time[0] += jstat["time"]
    jstat["pade"] = hp.use_pade
    jstat["pade_log"] = getattr(solver, "pade_log", [])
    return jstat


def _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                 eval_potential):
    m = deformable.mesh
    jstat["force_rms_recomp"] = eval_force_rms()
    jstat["potential_recomp"] = eval_potential()
    jstat["displacement"] = relative_displacement(m.vertices, vtx_coord)
    jstat["nr_inverted"] = get_nr_inverted(m.tets, m.vertices, vtx_coord)
    jstat["V"] = m.nr_vertices
    jstat["F"] = m.nr_tet


# ----------------------------------------------------------------------------
# task functions (reference fea/main.cpp:584-1046)
# ----------------------------------------------------------------------------


def test_single_tet_inverse(config, rootpath="."):
    """Reference ``test_single_tet_inverse`` (``fea/main.cpp:584-621``)."""
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    angle = 2 * math.pi / 3
    coords = np.zeros((4, 3))
    for i in range(3):
        coords[i, 0] = math.cos(angle * i) * spacing
        coords[i, 1] = math.sin(angle * i) * spacing
    coords[3, 2] = spacing
    mesh = TetrahedralMesh(coords, np.arange(4)[None, :])
    body = DeformableBody(material, mesh)
    body.coord_fixed_mask[:3, :] = True

    f_load_full = np.zeros((4, 3))
    f_load_full[3, 2] = -1000.0
    res = run_and_save(
        "single tet inv", config, body, True, f_load_full
    )
    for i in range(4):
        a, b = coords[i], res.mesh.vertices[i]
        print(
            "vertex %d: (%.3f, %.3f, %.3f) -> (%.3f, %.3f, %.3f)"
            % (i, *a, *b)
        )
    return res


def test_cuboid(config, rootpath="."):
    """Reference ``test_cuboid`` (``fea/main.cpp:623-663``)."""
    nx, ny, nz = int(config["x"]), int(config["y"]), int(config["z"])
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    body = DeformableBody(material, mesh)
    vtx = mesh.vertices
    body.coord_fixed_mask[vtx[:, 0] <= spacing / 2, :] = True
    f_load_full = np.zeros((mesh.nr_vertices, 3))
    sel = (vtx[:, 0] > (nx // 2 - 1) * spacing - spacing / 2) & (
        vtx[:, 2] < spacing / 2
    )
    f_load_full[sel, 2] = -50.0
    inverse = bool(config.get("inverse", False))
    return run_and_save(
        "cuboid inverse" if inverse else "cuboid", config, body, inverse,
        f_load_full,
    )


def test_cuboid_twist(config, rootpath="."):
    """Reference ``test_cuboid_twist`` (``fea/main.cpp:665-772``):
    incremental rotation (about x) of the right face, then bend steps
    (rotation about z + shift) with refinement."""
    nx, ny, nz = int(config["x"]), int(config["y"]), int(config["z"])
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    print("cuboid twist: V=%d F=%d" % (mesh.nr_vertices, mesh.nr_tet))
    body = DeformableBody(material, mesh)
    x_thresh = spacing * (nx - 1.5)
    vtx_cur = mesh.vertices.copy()
    left = vtx_cur[:, 0] <= spacing / 2
    right = vtx_cur[:, 0] >= x_thresh
    body.coord_fixed_mask[left | right, :] = True
    vtx_bnd_idx = np.nonzero(right)[0]
    sanm_assert(len(vtx_bnd_idx) > 0)

    vtx_delta = np.zeros_like(vtx_cur)
    out_filename = config["out_filename"]
    save_cnt = [0]

    def save():
        TetrahedralMesh(
            vtx_cur, mesh.tets, mesh.surface_vtx, mesh.surfaces
        ).write_obj("%s-%d.obj" % (out_filename, save_cnt[0]))
        save_cnt[0] += 1

    last_stat = {}

    def update_to_next(name, vtx_bnd_next, require_refine, cfg):
        nonlocal last_stat
        vtx_delta[:] = 0
        vtx_delta[vtx_bnd_idx] = vtx_bnd_next - vtx_cur[vtx_bnd_idx]
        last_stat = run_with_vtx_delta(
            name, cfg, body, vtx_delta, vtx_cur, require_refine
        )
        save()

    save_interm = bool(config.get("save_interm", False))
    cfg_rot = dict(config)
    cfg_rot["save_interm"] = False
    rotate_split = float(config.get("rotate_split", 90))
    remain = float(config["rotate"])
    finished = 0.0
    save()
    vtx_bnd_init = vtx_cur[vtx_bnd_idx].copy()
    qcnt = 0
    while remain > 1e-5:
        rot = min(remain, rotate_split)
        remain -= rot
        finished += rot
        ang = math.radians(finished)
        rmat = np.array(
            [
                [1, 0, 0],
                [0, math.cos(ang), -math.sin(ang)],
                [0, math.sin(ang), math.cos(ang)],
            ]
        )
        nxt = vtx_bnd_init @ rmat.T
        nxt += vtx_bnd_init.mean(0) - nxt.mean(0)
        update_to_next(
            "rot%d(rem %.1f)" % (qcnt, remain), nxt, False, cfg_rot
        )
        qcnt += 1

    vtx_bnd_init = vtx_cur[vtx_bnd_idx].copy()
    cfg_bend = dict(config)
    cfg_bend["save_interm"] = save_interm
    for bend in config["bend"]:
        ang = math.radians(float(bend["angle"]))
        shift = np.asarray(bend["shift"], float)
        rmat = np.array(
            [
                [math.cos(ang), -math.sin(ang), 0],
                [math.sin(ang), math.cos(ang), 0],
                [0, 0, 1],
            ]
        )
        nxt = vtx_bnd_init @ rmat.T + shift * spacing
        update_to_next("bend", nxt, True, cfg_bend)

    last_stat["V"] = mesh.nr_vertices
    last_stat["F"] = mesh.nr_tet
    save_json(out_filename + ".json", last_stat)
    out_mesh = mesh.copy()
    out_mesh.replace_vtx(vtx_cur)
    return TaskResult(out_mesh, last_stat)


def setup_boundary_by_config(body: DeformableBody, default_proj_dir, config):
    """Fix surface vertices below a projection threshold (reference
    ``setup_boundary_by_config``, ``fea/main.cpp:921-982``)."""
    mesh = body.mesh
    vtx = mesh.vertices
    proj_dir = np.asarray(
        config.get("boundary_proj_dir", default_proj_dir), float
    )
    proj_dir = proj_dir / np.linalg.norm(proj_dir)
    p = vtx @ proj_dir
    thresh = p.min() + (p.max() - p.min()) * float(
        config["boundary_thresh"]
    )
    print("proj range: %g %g thr=%g" % (p.min(), p.max(), thresh))

    keep = np.ones(mesh.nr_vertices, bool)
    if "boundary_filter" in config:
        fcfg = config["boundary_filter"]
        fdir = np.asarray(fcfg["dir"], float)
        fp = vtx @ fdir
        d = fp.max() - fp.min()
        th0 = fp.min() + d * float(fcfg["min"])
        th1 = fp.min() + d * float(fcfg["max"])
        print("filter range: [%g, %g]" % (th0, th1))
        keep = (fp >= th0) & (fp <= th1)

    surface = np.zeros(mesh.nr_vertices, bool)
    sanm_assert(mesh.surface_vtx)
    surface[list(mesh.surface_vtx)] = True
    sel = (p <= thresh) & surface & keep
    body.coord_fixed_mask[sel, :] = True


def _gravity_load(mesh, material, g_acc):
    """Per-tet gravity lumped to the four corners (reference
    ``fea/main.cpp:1026-1036``)."""
    vols = mesh.tet_volumes
    grav = vols[:, None] * material.density * np.asarray(g_acc)[None, :]
    f = np.zeros((mesh.nr_vertices, 3))
    np.add.at(f, mesh.tets.reshape(-1),
              np.repeat(grav / 4.0, 4, axis=0))
    tot = float(np.linalg.norm(grav, axis=1).sum())
    return f, tot


def gravity_body(config, rootpath="."):
    """The gravity task's body, boundary and load, without solving:
    returns ``(mesh_file, body, f_load_full, tot_gravity)``."""
    material = make_material_property(config["material"], need_density=True)
    mesh_file = os.path.join(rootpath, config["mesh"])
    mesh = TetrahedralMesh.from_tetgen_files(mesh_file)
    body = DeformableBody(material, mesh)
    g_acc = np.asarray(config["g"], float)
    if "scale" in config:
        mesh.resize_inplace(float(config["scale"]))

    bou_path = mesh_file + ".bou"
    if os.path.exists(bou_path):
        with open(bou_path) as f:
            for tok in f.read().split():
                idx = int(tok)
                sanm_assert(idx > 0)
                body.coord_fixed_mask[idx - 1, :] = True
    else:
        print("bou file does not exist; fix lowest points ...")
        setup_boundary_by_config(body, -g_acc, config)
    f_load_full, tot_gravity = _gravity_load(mesh, material, g_acc)
    return mesh_file, body, f_load_full, tot_gravity


def gravity(config, rootpath="."):
    """Reference ``gravity`` (``fea/main.cpp:984-1046``)."""
    mesh_file, body, f_load_full, tot_gravity = gravity_body(
        config, rootpath
    )
    mesh = body.mesh
    fixed_vid = set(np.nonzero(body.coord_fixed_mask[:, 0])[0].tolist())
    mesh.write_obj(config["out_filename"] + "-boundary.obj", fixed_vid)

    print(
        "mesh loading finished %s:\n nr_vtx=%d nr_tet=%d boundary_vtx=%d "
        "gravity=%.3f"
        % (mesh_file, mesh.nr_vertices, mesh.nr_tet, len(fixed_vid),
           tot_gravity)
    )
    return run_and_save(
        "mesh %s" % os.path.basename(mesh_file), config, body,
        bool(config.get("inverse", False)), f_load_full,
    )


def mesh_twist(config, rootpath="."):
    """Reference ``mesh_twist`` (``fea/main.cpp:774-919``)."""
    material = make_material_property(config["material"])
    mesh_file = os.path.join(rootpath, config["mesh"])
    mesh = TetrahedralMesh.from_tetgen_files(mesh_file)
    if float(config.get("scale", 0)) > 0:
        mesh.resize_inplace(float(config["scale"]))
    print("mesh twist: V=%d F=%d" % (mesh.nr_vertices, mesh.nr_tet))
    body = DeformableBody(material, mesh)
    twist_axis = np.asarray(config["axis"], float)
    out_filename = config["out_filename"]

    p = mesh.vertices @ twist_axis
    proj_dist = float(p.max() - p.min())
    th0 = p.min() + (p.max() - p.min()) * float(config["ratio_lo"])
    th1 = p.min() + (p.max() - p.min()) * (1 - float(config["ratio_hi"]))
    include_int = bool(config.get("include_int_points", False))
    surface = np.zeros(mesh.nr_vertices, bool)
    sanm_assert(mesh.surface_vtx)
    surface[list(mesh.surface_vtx)] = True
    print("proj range: %g %g thr=%g,%g" % (p.min(), p.max(), th0, th1))
    sel = ((p <= th0) | (p >= th1)) & (surface | include_int)
    body.coord_fixed_mask[sel, :] = True
    vtx_bnd_idx = np.nonzero(sel & (p >= th1))[0]
    fixed_vid = set(np.nonzero(body.coord_fixed_mask[:, 0])[0].tolist())
    mesh.write_obj(out_filename + "-orig.obj")
    mesh.write_obj(out_filename + "-boundary.obj", fixed_vid)

    f_load_full = None
    if config.get("add_gravity", False):
        g_acc = np.asarray(config["g"], float)
        f_load_full, tot = _gravity_load(mesh, material, g_acc)
        print("add gravity=%.3f" % tot)
        cfg2 = dict(config)
        cfg2["save_interm"] = False
        mesh_deformed = run_and_save(
            "gravity_init", cfg2, body, False, f_load_full, save=False
        ).mesh
        mesh_deformed.write_obj(out_filename + "-gravity.obj")
        vtx_cur = mesh_deformed.vertices.copy()
    else:
        vtx_cur = mesh.vertices.copy()

    vtx_bnd_next = vtx_cur[vtx_bnd_idx].copy()

    def apply_trans(tc):
        nonlocal vtx_bnd_next
        ang = math.radians(float(tc["angle"]))
        shift = np.asarray(tc["shift"], float)
        rot_axis = int(tc.get("rot_axis", 2))
        rmat = np.eye(3)
        rs = np.array(
            [[math.cos(ang), -math.sin(ang)], [math.sin(ang), math.cos(ang)]]
        )
        ax = [i for i in range(3) if i != rot_axis]
        for a, i in enumerate(ax):
            for b, j in enumerate(ax):
                rmat[i, j] = rs[a, b]
        vtx_bnd_next = vtx_bnd_next @ rmat.T + shift * proj_dist

    for tc in config.get("transforms", [config]):
        apply_trans(tc)

    vtx_delta = np.zeros_like(vtx_cur)
    vtx_delta[vtx_bnd_idx] = vtx_bnd_next - vtx_cur[vtx_bnd_idx]

    mesh_copy = mesh.copy()
    mesh_copy.replace_vtx(vtx_cur + vtx_delta)
    mesh_copy.write_obj(out_filename + "-boundary-dst.obj", fixed_vid)

    stat = run_with_vtx_delta(
        "mesh_twist", config, body, vtx_delta, vtx_cur, False, f_load_full
    )
    mesh.replace_vtx(vtx_cur)
    mesh.write_obj(out_filename + ".obj")
    save_json(out_filename + ".json", stat)
    if "out_surface_vtx" in config:
        mesh.write_surface_vtx(config["out_surface_vtx"])
    return TaskResult(mesh, stat)


def _with_warm_rerun(fn):
    """Warm-timing wrapper for the continuation tasks (``mesh_twist``,
    ``test_cuboid_twist``), whose solvers are rebuilt per transform step:
    under ``SANM_WARM_TIMING`` the whole task runs a second time in the
    same process, so the re-run's jit lookups hit the in-process /
    persistent compile caches — the long-lived-process analog used by
    the equilibrium tasks (``run_and_save``)."""

    def wrapped(config, rootpath="."):
        res = fn(config, rootpath)
        if os.environ.get("SANM_WARM_TIMING"):
            solve_begin = _total_solve_time[0]
            t = Timer().start()
            res = fn(config, rootpath)
            wall = t.stop().time()
            # time_solve_warm counts the SOLVER portion only (summed
            # run_with_vtx_delta/run_and_save solve timers of the
            # re-run), matching the equilibrium tasks' semantics; the
            # full task re-run wall time (mesh re-load, boundary setup,
            # OBJ writes included) goes to time_task_warm
            res.stat["time_solve_warm"] = _total_solve_time[0] - solve_begin
            res.stat["time_task_warm"] = wall
            save_json(config["out_filename"] + ".json", res.stat)
        return res

    wrapped.__name__ = fn.__name__
    return wrapped


TASKS = {
    "test_single_tet_inverse": test_single_tet_inverse,
    "test_cuboid": test_cuboid,
    "test_cuboid_twist": _with_warm_rerun(test_cuboid_twist),
    "gravity": gravity,
    "mesh_twist": _with_warm_rerun(mesh_twist),
}


def do_main(argv):
    """Reference ``do_main`` (``fea/main.cpp:1066-1102``)."""
    if len(argv) < 2:
        print(
            "usage: python -m sanm_tpu.fea <system config> <task config> "
            "[override json ...]"
        )
        return -1
    sys_config = read_json(argv[0])
    # system config: verbosity/threads — thread counts have no analog
    # under SPMD; accepted for config compatibility (reference
    # fea/main.cpp:1055-1063)
    _ = sys_config.get("threads")
    config = merge_configs(argv[1:])
    func = config["func"]
    if func not in TASKS:
        raise SANMError("unknown func: %s" % func)
    rootpath = os.path.dirname(os.path.abspath(argv[1]))
    t0 = time.time()
    prof_mode = os.environ.get("SANM_PROFILE")
    if prof_mode == "trace":
        # XLA device trace (open in TensorBoard / Perfetto); host-side
        # scope stats still come from ScopedProfiler below
        import jax

        trace_dir = os.environ.get("SANM_TRACE_DIR", "sanm_trace")
        with jax.profiler.trace(trace_dir):
            TASKS[func](config, rootpath)
        print("profiler trace written to %s" % trace_dir)
    else:
        TASKS[func](config, rootpath)
    print("total time: %.3fs" % (time.time() - t0))
    if prof_mode:
        print(ScopedProfiler.report())
    return 0
