"""Scenario sweep CLI of the port: run registered scenarios with resumable
JSON output (counterpart of ``scripts/sweep.py``).

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios --preset fig6 --out sweep.json
    PYTHONPATH=src python -m repro_torch.scenarios --all --seeds 1 --quick --out sweep.json
    PYTHONPATH=src python -m repro_torch.scenarios --churn-combinations --quick \\
        --device cpu --out sweep.json

Runs on the CUDA card unless ``--device cpu`` is given.  The output file is
rewritten after every completed scenario and already-recorded ``(scenario,
seed, quick)`` triples are skipped on re-entry, so an interrupted sweep
resumes where it stopped (``--no-resume`` starts over).  The records have
``repro``'s schema (``docs/benchmarks.md``); ``--out`` is required, so a run
never writes over ``repro``'s ``BENCH_scenarios.json`` by default.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios",
                                 description=__doc__.split("\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--list", action="store_true",
                      help="print registered scenarios and exit")
    what.add_argument("--preset", default=None,
                      help="comma-separated scenario names to run")
    what.add_argument("--all", action="store_true",
                      help="run every registered scenario")
    what.add_argument("--new-combinations", action="store_true",
                      help="run the non-figure scenario combinations")
    what.add_argument("--async-combinations", action="store_true",
                      help="run the async/overlap event-engine combinations")
    what.add_argument("--churn-combinations", action="store_true",
                      help="run the trace-driven fleet-dynamics combinations")
    what.add_argument("--async-fl-combinations", action="store_true",
                      help="run the barrier-free gossip-FL combinations")
    ap.add_argument("--out", default=None, help="output JSON path (required to run)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="run each scenario under seeds 0..N-1 (default: 1)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized sampling/iteration budgets")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing records in --out and start fresh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.scenarios import list_scenarios, run_sweep
    from repro_torch.scenarios.presets import (
        ASYNC_COMBINATIONS,
        ASYNC_FL_COMBINATIONS,
        CHURN_COMBINATIONS,
        NEW_COMBINATIONS,
    )

    registry = list_scenarios()
    if args.list:
        for name, sc in registry.items():
            ax = sc.axes()
            print(f"{name:24s} {ax['topology']:12s} N_T={ax['num_tasks']:<4d} "
                  f"N_K={ax['num_machines']:<3d} machines={ax['machine_profile']:10s} "
                  f"delays={ax['delay_model']:9s} exec={ax['execution']:7s} "
                  f"fl={'yes' if ax['fl'] else 'no':3} "
                  f"churn={ax['churn'] or '-'}")
        return 0
    if args.out is None:
        print("--out is required to run scenarios", file=sys.stderr)
        return 2

    if args.preset:
        names = [n.strip() for n in args.preset.split(",") if n.strip()]
        unknown = [n for n in names if n not in registry]
        if unknown:
            print(f"unknown scenario(s): {unknown}; see --list", file=sys.stderr)
            return 2
        base = [registry[n] for n in names]
    elif args.new_combinations:
        base = list(NEW_COMBINATIONS)
    elif args.async_combinations:
        base = list(ASYNC_COMBINATIONS)
    elif args.churn_combinations:
        base = list(CHURN_COMBINATIONS)
    elif args.async_fl_combinations:
        base = list(ASYNC_FL_COMBINATIONS)
    else:
        base = list(registry.values())

    scenarios = [sc.with_seed(s) for sc in base for s in range(args.seeds)]
    payload = run_sweep(
        scenarios,
        out_path=args.out,
        quick=args.quick,
        resume=not args.no_resume,
        progress=print,
        device=args.device,
    )
    print(f"{len(payload['records'])} record(s) in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
