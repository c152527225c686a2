#!/usr/bin/env python
"""Aggregate experiment stat JSONs into comparison tables.

Counterpart of the reference's paper-table generator
(``render/gen_table_figs.py``): geometric-mean speedup of the ANM
solver over the Newton/LevMar baselines (``gen_table_figs.py:341-375``),
the Pade benefit in iterations saved (``:341-359``), and per-cell
timing/accuracy tables.

Usage: python scripts/gen_tables.py results/
"""

import glob
import json
import math
import os
import re
import sys
from collections import defaultdict


def load_cells(root):
    cells = {}
    for done in glob.glob(os.path.join(root, "*", "done")):
        cell_dir = os.path.dirname(done)
        name = os.path.basename(cell_dir)
        stats = {}
        for js in glob.glob(os.path.join(cell_dir, "*.json")):
            try:
                stats[os.path.basename(js)] = json.load(open(js))
            except Exception:
                pass
        if stats:
            # prefer the task-level stat (contains time/time_solve)
            best = None
            for v in stats.values():
                if "time_solve" in v or "time" in v:
                    best = v
                    break
            if best is None:
                # reference-protocol N/A or deterministic infeasibility
                # (run_experiments.protocol_na_reason and the
                # inverted-init catch): a structured non-blank cell
                for key in ("protocol_na.json", "infeasible.json"):
                    if key in stats:
                        best = {"na": True,
                                "reason": stats[key].get("reason", "")}
                        break
            if best is None and "timeout.json" in stats:
                # run killed at the cell budget: the wall time is a
                # measured LOWER BOUND (run_experiments.py records it;
                # the reference's "thousands of times faster than
                # LevMar" README claim is the same >=-bound shape)
                best = {
                    "time_solve": float(stats["timeout.json"]["timeout_s"]),
                    "timed_out": True,
                }
            cells[name] = best if best is not None else list(
                stats.values()
            )[0]
    return cells


_PROF_LINE = re.compile(
    r"^(\s*)([\w<>]+): calls=\d+ tot=([\d.]+)s", re.M
)


def sparse_share(cell_dir, stat=None):
    """Share of the WARM solve spent in the sparse solver — the
    reference's statistic over its ``time_solve`` denominator
    (``render/gen_table_figs.py:328-339``).

    Preferred source: the ``sparse_share_warm`` stat key (measured
    exactly around the warm re-solve).  Fallback for older cells: the
    log's ScopedProfiler totals cover cold+warm; the sparse scopes are
    pure host work with no compilation, so the warm half is estimated
    as total/2 and divided by ``time_solve_warm``."""
    if stat is not None and "sparse_share_warm" in stat:
        return stat["sparse_share_warm"]
    log = os.path.join(cell_dir, "log.txt")
    if not os.path.exists(log):
        return None
    tot = {}
    for _, name, secs in _PROF_LINE.findall(open(log).read()):
        tot[name] = tot.get(name, 0.0) + float(secs)
    sparse = tot.get("sparse_prep", 0.0) + tot.get("sparse_solve", 0.0)
    if not sparse:
        return None
    warm = (stat or {}).get("time_solve_warm")
    if warm:
        return (sparse / 2.0) / warm
    solve = tot.get("solve_expansion_coeffs")
    if not solve:
        return None
    return sparse / solve


def cell_time(stat):
    # warm > cold time_solve > total: warm excludes XLA compile /
    # cache-deserialization, matching the reference's long-lived-process
    # timing protocol.  A zero warm value means "no warm re-solve of
    # this kind ran" (e.g. deform-task baselines, whose warm leg is
    # time_task_warm) — fall through rather than reporting 0.000 s.
    for key in ("time_solve_warm", "time_solve", "time"):
        v = stat.get(key)
        if v:
            return v
    return float("nan")


def gmean(xs):
    xs = [x for x in xs if x > 0 and math.isfinite(x)]
    if not xs:
        return float("nan")
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "results"
    cells = load_cells(root)
    if not cells:
        print("no completed cells under", root)
        return

    print("=== per-cell results ===")
    print(f"{'cell':<50} {'time':>9} {'iter':>5} {'force_rms':>10}")
    for name in sorted(cells):
        s = cells[name]
        if s.get("na"):
            print(f"{name:<50} {'n/a':>9}  (protocol/infeasible)")
            continue
        mark = ">=" if s.get("timed_out") else ""
        print(
            f"{name:<50} {mark + format(cell_time(s), '.3f'):>9} "
            f"{s.get('iter', s.get('iter_tot', '-')):>5} "
            f"{s.get('force_rms_recomp', s.get('force_rms', float('nan'))):>10.2e}"
        )

    # speedups: sanm vs each baseline on matching (mesh, energy, task)
    by_key = defaultdict(dict)
    for name, s in cells.items():
        parts = name.split("-")
        # mesh-energy-solver-task; energy/solver may contain '_'
        # reconstruct: task is last, mesh is first, middle = energy-solver
        mesh, rest = parts[0], parts[1:]
        task = rest[-1]
        mid = "-".join(rest[:-1])
        for solver in (
            "sanm_no_pade", "sanm_band", "sanm_dense_chol",
            "baseline_noproj", "baseline_levmar",
            "baseline", "sanm",
        ):
            if mid.endswith(solver):
                energy = mid[: -(len(solver) + 1)]
                by_key[(mesh, energy, task)][solver] = s
                break

    # full solver-variant comparison table (the reference's 5-variant
    # protocol, render/cmp_with_baseline.sh:40-57 + Makefile targets)
    variants = ("sanm", "sanm_no_pade", "baseline", "baseline_noproj",
                "baseline_levmar")
    multi = {k: d for k, d in by_key.items() if len(d) > 1}
    if multi:
        print("\n=== solver-variant comparison (time, s; '>=' = killed "
              "at budget) ===")
        hdr = f"{'mesh-energy-task':<38}" + "".join(
            f"{v:>17}" for v in variants
        )
        print(hdr)
        for key in sorted(multi):
            d = multi[key]
            row = f"{'-'.join(key):<38}"
            for v in variants:
                if v not in d:
                    row += f"{'-':>17}"
                elif d[v].get("na"):
                    row += f"{'n/a':>17}"
                else:
                    t = cell_time(d[v])
                    mark = ">=" if d[v].get("timed_out") else ""
                    row += f"{mark + format(t, '.2f'):>17}"
            print(row)

    levmar_ratios = []
    for base in ("baseline", "baseline_noproj", "baseline_levmar"):
        ratios = []
        lower = False
        for key, d in by_key.items():
            if "sanm" in d and base in d:
                if d[base].get("na") or d["sanm"].get("na"):
                    continue
                r = cell_time(d[base]) / cell_time(d["sanm"])
                ratios.append(r)
                lower |= bool(d[base].get("timed_out"))
                if base == "baseline_levmar":
                    levmar_ratios.append(
                        ("-".join(key), r, d[base].get("timed_out", False))
                    )
        if ratios:
            bound = ">=" if lower else ""
            print(
                f"\ngmean speedup sanm vs {base}: {bound}"
                f"{gmean(ratios):.2f}x ({len(ratios)} cells)"
            )

    if levmar_ratios:
        # LevMar speedup figure (the reference's headline README claim
        # is the SANM-vs-LevMar ratio; README.md:13-15)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            names = [n for n, _, _ in levmar_ratios]
            vals = [r for _, r, _ in levmar_ratios]
            fig, ax = plt.subplots(
                figsize=(1.2 + 0.9 * len(names), 3.2)
            )
            bars = ax.bar(range(len(vals)), vals)
            for i, (_, r, to) in enumerate(levmar_ratios):
                if to:
                    ax.text(i, r, ">=", ha="center", va="bottom")
            ax.set_xticks(range(len(names)))
            ax.set_xticklabels(
                [n.replace("-", "\n") for n in names], fontsize=7
            )
            ax.set_yscale("log")
            ax.set_ylabel("speedup vs LevMar (x)")
            fig.tight_layout()
            out = os.path.join(root, "levmar_speedup.png")
            fig.savefig(out, dpi=120)
            print(f"LevMar speedup figure: {out}")
        except Exception as e:  # pragma: no cover
            print("  (LevMar figure skipped: %s)" % e)

    # Pade benefit: iterations saved (gen_table_figs.py:341-359)
    saved = []
    for key, d in by_key.items():
        if "sanm" in d and "sanm_no_pade" in d:
            i0 = d["sanm_no_pade"].get(
                "iter", d["sanm_no_pade"].get("iter_tot")
            )
            i1 = d["sanm"].get("iter", d["sanm"].get("iter_tot"))
            if i0 is not None and i1 is not None:
                saved.append(i0 - i1)
    if saved:
        mean = sum(saved) / len(saved)
        print(f"\nPade benefit: {mean:.2f} iterations saved on average "
              f"({len(saved)} cells)")

    # Pade acceptance diagnostics (per-restart pade_log: is the
    # acceptance rejecting extensions the reference would take?)
    n_acc = n_rej = 0
    gains = []
    rejects = defaultdict(int)
    for name, s in cells.items():
        for rec in s.get("pade_log") or []:
            if rec.get("accepted"):
                n_acc += 1
                gains.append(rec.get("gain", 1.0))
            else:
                n_rej += 1
                reason = rec.get("reject", "?")
                rejects[reason.split(" ")[0] + " " + reason.split(" ")[1]
                        if " " in reason else reason] += 1
    if n_acc + n_rej:
        g = gmean(gains) if gains else float("nan")
        print(f"\nPade acceptance: {n_acc}/{n_acc + n_rej} restarts "
              f"accepted; gmean range gain {g:.2f}x when accepted")
        for reason, cnt in sorted(rejects.items(), key=lambda kv: -kv[1]):
            print(f"  reject[{reason}]: {cnt}")

    # device-count scaling curve (gen_table_figs.py:60-81): reads the
    # run_scaling.py output if present and writes a plot next to it
    for scal in glob.glob(os.path.join(root, "scaling*.json")):
        try:
            data = json.load(open(scal))
        except Exception:
            continue
        rs = data.get("results", [])
        if len(rs) < 2:
            continue
        t1 = next(
            (r["time_solve_warm"] for r in rs if r["n_devices"] == 1), None
        )
        print(f"\nscaling ({os.path.basename(scal)}; "
              f"valid_parallel_timing={data.get('valid_parallel_timing')}):")
        for r in rs:
            sp = t1 / r["time_solve_warm"] if t1 else float("nan")
            print(f"  {r['n_devices']:>2} device(s): "
                  f"{r['time_solve_warm']:.2f}s  ({sp:.2f}x vs 1)")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            ns = [r["n_devices"] for r in rs]
            ts = [r["time_solve_warm"] for r in rs]
            fig, ax = plt.subplots(figsize=(4, 3))
            ax.plot(ns, ts, "o-", label="measured")
            if t1:
                ax.plot(ns, [t1 / n for n in ns], "--", label="ideal 1/x")
            ax.set_xlabel("devices")
            ax.set_ylabel("warm time_solve (s)")
            ax.set_xscale("log", base=2)
            ax.set_yscale("log")
            ax.legend()
            fig.tight_layout()
            out = scal.replace(".json", ".png")
            fig.savefig(out, dpi=120)
            print(f"  plot: {out}")
        except Exception as e:  # pragma: no cover
            print("  (plot skipped: %s)" % e)

    # problem-size scaling curves (run_size_scaling.py; the
    # one-accelerator counterpart of the reference thread-scalability
    # figure): one
    # combined plot over every size_scaling_*.json found
    size_files = sorted(glob.glob(os.path.join(root, "size_scaling_*.json")))
    series = []
    for sf in size_files:
        try:
            data = json.load(open(sf))
        except Exception:
            continue
        rows = [r for r in data.get("rows", [])
                if r.get("warm_s") and not r.get("error")]
        if not rows:
            continue
        label = data.get("solver", os.path.basename(sf))
        series.append((label, rows))
        print(f"\nsize scaling ({os.path.basename(sf)}, "
              f"{data.get('energy')}, order {data.get('order')}):")
        for r in rows:
            print(f"  n={r['n_dofs']:>7} ({r['n_tets']} tets): "
                  f"warm={r['warm_s']:.2f}s cold={r['cold_s']:.1f}s "
                  f"iters={r['iters']} rms={r['force_rms']:.1e}")
    if series:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(4.5, 3.2))
            for label, rows in series:
                ns = [r["n_dofs"] for r in rows]
                ts = [r["warm_s"] for r in rows]
                ax.plot(ns, ts, "o-", label=label)
            n0, t0 = series[0][1][0]["n_dofs"], series[0][1][0]["warm_s"]
            nmax = max(r["n_dofs"] for _, rows in series for r in rows)
            ax.plot([n0, nmax], [t0, t0 * nmax / n0], "k--",
                    alpha=0.5, label="O(n)")
            ax.set_xlabel("unknowns n (constant bandwidth)")
            ax.set_ylabel("warm time_solve (s)")
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.legend(fontsize=8)
            fig.tight_layout()
            out = os.path.join(root, "size_scaling.png")
            fig.savefig(out, dpi=120)
            print(f"  plot: {out}")
        except Exception as e:  # pragma: no cover
            print("  (plot skipped: %s)" % e)

    # sparse-solver share of solve time (gen_table_figs.py:328-339)
    shares = []
    for name in sorted(cells):
        if "-sanm-" not in name:
            continue
        sh = sparse_share(os.path.join(root, name), cells[name])
        if sh is not None:
            shares.append(sh)
    if shares:
        mean = sum(shares) / len(shares)
        print(f"\nsparse-solver share of WARM solve time: {mean:.1%} mean "
              f"({len(shares)} sanm cells)")


if __name__ == "__main__":
    main()
