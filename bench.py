"""Benchmark: the reference's Armadillo-small gravity workload on one GPU.

Solves the reference config ``config/armadillo_small.json`` (V=13665,
T=42288 tetrahedra, compressible Neo-Hookean, Taylor order 20, Padé on)
to the paper's convergence target force-RMS 1e-10 (``fea/main.cpp:28``)
and prints ONE JSON line.

``value`` is the *warm* solve time: the best of three full re-solves on
a long-lived solver (compiled kernels + host assembler reused) — the
analog of the reference's in-process timing, excluding XLA compilation.
``--newton`` also runs the projected-Newton baseline (reference
``fea/baseline``, reimplemented in JAX) in the same process after the
SANM leg — one process per card — and reports ``vs_baseline`` = Newton
warm time over SANM warm time (the reference's headline protocol,
``render/cmp_with_baseline.sh``).  Every number is printed beside the
card's name and power limit.  Exits non-zero without a result when JAX
finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


def run_solve(*configs):
    from sanm_tpu.fea.app import TASKS, merge_configs

    config = merge_configs([os.path.join(CONFIG_DIR, c) for c in configs])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            return TASKS[config["func"]](config, CONFIG_DIR).stat
        finally:
            os.chdir(cwd)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--newton", action="store_true",
                    help="also time the projected-Newton baseline")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench: no GPU (JAX platform %r); refusing to run"
                 % dev.platform)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()

    os.environ["SANM_WARM_TIMING"] = "3"
    import sanm_tpu

    sanm_tpu.enable_compile_cache()
    stat = run_solve("armadillo_small.json")
    t_warm = stat["time_solve_warm"]
    newton = run_solve("armadillo_small.json", "override_baseline.json") \
        if args.newton else None

    print(json.dumps({
        "metric": "warm time_solve Armadillo-small NHC gravity order=20 "
        "to force-RMS 1e-10",
        "value": t_warm,
        "unit": "s",
        "card": card,
        "vs_baseline": newton["time_solve_warm"] / t_warm if newton else None,
        "detail": {
            "iters": stat["iter"],
            "warm_samples": stat["warm_samples"],
            "force_rms": stat["force_rms_recomp"],
            "cold_time_solve_s": stat["time_solve"],
            "newton_warm_s": newton["time_solve_warm"] if newton else None,
            "newton_iters": newton.get("iter_tot") if newton else None,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "host_cores": os.cpu_count(),
            "mesh": {"V": stat["mesh_V"], "T": stat["mesh_F"]},
        },
    }))


if __name__ == "__main__":
    main()
