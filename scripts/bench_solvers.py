#!/usr/bin/env python
"""Linear-solver backend shootout on the gravity workload.

Counterpart of the reference's single-path PARDISO benchmarking: here
the factorize-once/N-backsolve structure is provided by several
backends (``sanm_tpu/solver/linear.py``) and the ``auto`` policy picks
by size/backend; this script produces the measured table that justifies
the policy.  Each backend runs in its own process, one after another, so
no two processes share a card.

Runs one mesh x energy gravity solve per backend in a fresh
subprocess, reporting warm re-solve wall time, iterations, and final
force-RMS.

Usage:
    python scripts/bench_solvers.py --mesh bob.json --solvers host_lu cg
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, tempfile, time
solver = sys.argv[1]
mesh_cfg = sys.argv[2]
energy = sys.argv[3]
os.environ["SANM_WARM_TIMING"] = "1"
os.environ["SANM_SOLVER"] = solver
sys.path.insert(0, %(repo)r)
import sanm_tpu
sanm_tpu.enable_compile_cache()
from sanm_tpu.fea.app import TASKS, read_json
cfg = read_json(os.path.join(%(repo)r, "configs", mesh_cfg))
cfg["energy_model"] = energy
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    stat = TASKS[cfg["func"]](cfg, os.path.join(%(repo)r, "configs")).stat
print(json.dumps({
    "solver": solver,
    "warm_s": stat.get("time_solve_warm"),
    "cold_s": stat.get("time_solve"),
    "iters": stat.get("iter"),
    "force_rms": stat.get("force_rms_recomp"),
    "resolved": stat.get("solver_resolved"),
    "loop": stat.get("loop_resolved"),
    "n_dofs": 3 * stat["mesh_V"],
}))
"""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="bob.json")
    p.add_argument("--energy", default="neohookean_c")
    p.add_argument("--solvers", nargs="+", default=["host_lu", "cg"])
    p.add_argument("--timeout", type=int, default=5400)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    results = []
    for solver in args.solvers:
        print("[solver-bench] %s ..." % solver, flush=True)
        out = subprocess.run(
            [sys.executable, "-c", CHILD % {"repo": REPO},
             solver, args.mesh, args.energy],
            capture_output=True, text=True, timeout=args.timeout,
        )
        row = None
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith('{"solver"'):
                row = json.loads(line)
        if row is None:
            print("  FAILED:\n%s\n%s" % (out.stdout[-1500:],
                                         out.stderr[-1500:]))
            row = {"solver": solver, "error": True}
        else:
            print("  warm=%.2fs iters=%s rms=%.2e (resolved=%s loop=%s)"
                  % (row["warm_s"], row["iters"], row["force_rms"],
                     row["resolved"], row["loop"]))
        results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mesh": args.mesh, "energy": args.energy,
                       "results": results}, f, indent=2)


if __name__ == "__main__":
    main()
