#!/usr/bin/env python
"""Device-count scaling curve for the element-sharded ANM solve.

Counterpart of the reference's thread-scalability experiment
(``render/run_armadillo_exprs.sh:30-36``, ``render/gen_table_figs.py:60-81``:
``time_solve`` at 1..32 threads on Armadillo gravity NHC, plotted against
ideal 1/x).  Here the scaling axis is JAX devices: the element batch is
sharded over a 1-D ``jax.sharding.Mesh`` (``sanm_tpu.parallel.ElemSharding``)
and each device count is measured in a fresh subprocess.

On a multi-GPU host, run with ``--platform gpu`` and the device counts
available there (each count in its own process, one after another, so
no two processes share a card).  Without multi-GPU hardware, a
virtual CPU mesh (``--xla_force_host_platform_device_count``) validates
the SPMD path; note that virtual devices share the host's physical
cores, so the curve only reflects real scaling when the host has at
least as many cores as devices (this is checked and recorded in the
output JSON).

Usage:
    python scripts/run_scaling.py --devices 1 2 4 8 --out scaling.json
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, time
import numpy as np

n_dev = int(sys.argv[1])
mesh_cfg = sys.argv[2]
energy = sys.argv[3]
order = int(sys.argv[4])

import jax
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, %(repo)r)
import sanm_tpu
sanm_tpu.enable_compile_cache()
from sanm_tpu.fea.app import gravity_body, read_json, run_anm_eqn, \
    setup_solver_param
from sanm_tpu.fea.material import EnergyModel
from sanm_tpu.parallel import ElemSharding
from sanm_tpu.solver import ANMEqnSolver

config = read_json(os.path.join(%(repo)r, "configs", mesh_cfg))
config["energy_model"] = energy
config["order"] = order
_, body, f_load_full, _ = gravity_body(
    config, os.path.join(%(repo)r, "configs"))

em = EnergyModel.from_name(config["energy_model"])
model = body.make_forward(em)
f_load_sub = model.lt_inp.copy_vtx_values(f_load_full)
hp = setup_solver_param(config, eqn=True)
hp.converge_rms = 1e-10

shard = ElemSharding(jax.devices()[:n_dev])
with shard.mesh:
    solver = ANMEqnSolver(
        model.fn, model.lt_inp.remap, model.lt_out.remap, model.x0(),
        f_load_sub, hp, shard_elems=shard,
    )
    run_anm_eqn(solver, progress=False)
    t0 = time.perf_counter()
    solver.reset()
    run_anm_eqn(solver, progress=False)
    warm = time.perf_counter() - t0
print(json.dumps({
    "n_devices": n_dev,
    "time_solve_warm": warm,
    "iters": solver.get_nr_iter(),
    "backend": jax.default_backend(),
}))
"""


def run_one(n_dev, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.platform == "cpu":
        flags = env.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=%d" % n_dev
            ).strip()
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", CHILD % {"repo": REPO},
         str(n_dev), args.mesh, args.energy, str(args.order)],
        env=env, capture_output=True, text=True, timeout=args.timeout,
    )
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        "scaling child (n=%d) produced no result:\n%s\n%s"
        % (n_dev, out.stdout[-2000:], out.stderr[-2000:])
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--mesh", default="armadillo_small.json")
    p.add_argument("--energy", default="neohookean_c")
    p.add_argument("--order", type=int, default=20)
    p.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    p.add_argument("--timeout", type=int, default=7200)
    p.add_argument("--out", default="scaling.json")
    args = p.parse_args()

    results = []
    for n in args.devices:
        print("[scaling] %d device(s) ..." % n, flush=True)
        r = run_one(n, args)
        r["host_cores"] = os.cpu_count()
        print("  warm=%.3fs iters=%d" % (r["time_solve_warm"], r["iters"]))
        results.append(r)
        with open(args.out, "w") as f:
            json.dump({
                "mesh": args.mesh, "energy": args.energy,
                "order": args.order, "platform": args.platform,
                "host_cores": os.cpu_count(),
                "valid_parallel_timing": (
                    args.platform == "gpu"
                    or os.cpu_count() >= max(args.devices)
                ),
                "results": results,
            }, f, indent=2)
    t1 = next((r for r in results if r["n_devices"] == 1), None)
    if t1:
        for r in results:
            r["speedup_vs_1dev"] = t1["time_solve_warm"] / r["time_solve_warm"]
        print("\nscaling: " + "  ".join(
            "%dx dev -> %.2fx" % (r["n_devices"], r["speedup_vs_1dev"])
            for r in results))


if __name__ == "__main__":
    main()
