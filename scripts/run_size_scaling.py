#!/usr/bin/env python
"""Problem-size scaling curve on ONE accelerator: the one-device
counterpart of the reference's thread-scalability experiment.

The reference scales the *machine* (1..32 MKL threads on a fixed
armadillo mesh, ``render/run_armadillo_exprs.sh:30-36``); its
scalability mesh ``Armadillo.1`` is not shipped (PARITY.md round 4).
On one device the natural scaling axis is the *problem*: a fixed card, meshes
of growing size.  This script grows the ``test_cuboid`` beam
(``fea/main.cpp:623-663``) along x at constant cross-section, so the
reverse-Cuthill-McKee semi-bandwidth is constant and the banded device
Cholesky (``solver/band.py``) is O(n) in both FLOPs and factor bytes —
the regime where a banded direct method on the device shines.

Each size runs in a fresh subprocess (fresh XLA programs; the compile
cache makes repeat invocations cheap).  Reports the best-of-N warm
re-solve per size (``SANM_WARM_TIMING``), plus factor stats.

Usage:
    python scripts/run_size_scaling.py --xs 20 40 80 160 320 \
        --solver band_chol --out size_scaling_band.json
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, tempfile, time
nx = int(sys.argv[1])
ny = int(sys.argv[2])
solver = sys.argv[3]
energy = sys.argv[4]
order = int(sys.argv[5])
os.environ["SANM_WARM_TIMING"] = os.environ.get("SANM_WARM_TIMING", "3")
if solver != "auto":
    os.environ["SANM_SOLVER"] = solver
sys.path.insert(0, %(repo)r)
import sanm_tpu
sanm_tpu.enable_compile_cache()
from sanm_tpu.fea.app import TASKS

cfg = {
    "func": "test_cuboid",
    # silicone-rubber cuboid of the reference test_cuboid config
    "material": {"type": "young_poisson", "young": 1e7, "poisson": 0.45},
    "energy_model": energy,
    "spacing": 0.025,
    "x": nx, "y": ny, "z": ny,
    "order": order,
    "out_filename": "cuboid",
}
t0 = time.time()
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    stat = TASKS[cfg["func"]](cfg, %(repo)r).stat
print(json.dumps({
    "x": nx, "y": ny,
    "n_dofs": 3 * stat["mesh_V"],
    "n_tets": stat["mesh_F"],
    "warm_s": stat.get("time_solve_warm"),
    "cold_s": stat.get("time_solve"),
    "wall_s": time.time() - t0,
    "iters": stat.get("iter"),
    "force_rms": stat.get("force_rms_recomp"),
    "resolved": stat.get("solver_resolved"),
    "loop": stat.get("loop_resolved"),
}))
"""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--xs", type=int, nargs="+",
                   default=[20, 40, 80, 160, 320])
    p.add_argument("--y", type=int, default=8,
                   help="cross-section cells (y=z); bandwidth knob")
    p.add_argument("--solver", default="band_chol")
    p.add_argument("--energy", default="neohookean_c")
    p.add_argument("--order", type=int, default=20)
    p.add_argument("--timeout", type=int, default=5400)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    rows = []
    for nx in args.xs:
        print("[size-scaling] x=%d y=z=%d ..." % (nx, args.y), flush=True)
        try:
            out = subprocess.run(
                [sys.executable, "-c", CHILD % {"repo": REPO},
                 str(nx), str(args.y), args.solver, args.energy,
                 str(args.order)],
                capture_output=True, text=True, timeout=args.timeout,
            )
        except subprocess.TimeoutExpired:
            print("  TIMEOUT (>%ds)" % args.timeout)
            rows.append({"x": nx, "y": args.y, "error": "timeout",
                         "timeout_s": args.timeout})
            continue
        row = None
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith('{"x"'):
                row = json.loads(line)
        if row is None:
            print("  FAILED:\n%s\n%s" % (out.stdout[-1500:],
                                         out.stderr[-1500:]))
            row = {"x": nx, "y": args.y, "error": True}
        else:
            print("  n=%d warm=%.2fs cold=%.1fs iters=%s rms=%.1e"
                  % (row["n_dofs"], row["warm_s"], row["cold_s"],
                     row["iters"], row["force_rms"]))
        rows.append(row)
        if args.out:  # write-as-you-go: resumable inspection mid-chain
            with open(args.out, "w") as f:
                json.dump({"solver": args.solver, "energy": args.energy,
                           "order": args.order, "rows": rows}, f, indent=2)


if __name__ == "__main__":
    main()
