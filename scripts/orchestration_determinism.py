"""Is a batched scenario solve the solve of the scenario alone, and is either
the same on every run?  The port's DR loop on ``device`` for the same-shape
groups that ``run_sweep`` batches (seeds 0..2 of ``ring_uniform`` and
``torus_cluster`` with their async twins, the quick budget).

    python3 scripts/orchestration_determinism.py [cuda|cpu] [--atomics]

For each scenario: whether two batched solves (``_presolve_groups``) give
bit-equal Y, whether two solves alone (``solve_sdp``) do, the largest |ΔY|
between the batch lane and the lone solve, the iterations of each, and the
sdp schedule's bottleneck through the batch and alone.  ``--atomics`` runs
the dense operator's sums with ``index_add_`` (CUDA atomics) instead of the
solver's sorted segment sums, to show what that changes.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _atomic_ops(original):
    """The dense operator's sums through ``index_add_``; the factored
    operator as the solver has it."""

    def make(kind, operands, n1, n_tasks, n_machines):
        if kind != "csr":
            return original(kind, operands, n1, n_tasks, n_machines)
        Lval, Lrow, Lcol, b = operands
        B, m = b.shape
        lane = torch.arange(B, device=b.device)[:, None]

        def matvec(v):
            dim = v.shape[1]
            return torch.zeros(B * m, dtype=v.dtype, device=v.device).index_add_(
                0, (Lrow + lane * m).reshape(-1),
                (Lval * v.reshape(-1)[Lcol + lane * dim]).reshape(-1)).view(B, m)

        def rmatvec(y, dim):
            return torch.zeros(B * dim, dtype=y.dtype, device=y.device).index_add_(
                0, (Lcol + lane * dim).reshape(-1),
                (Lval * y.reshape(-1)[Lrow + lane * m]).reshape(-1)).view(B, dim)

        return matvec, rmatvec, b

    return make


def main(argv: list[str]) -> int:
    import repro_torch.core.sdp as sdp_mod
    from repro_torch.core import build_bqp, build_factored_bqp, compare_methods, solve_sdp
    from repro_torch.core.scheduler import _pick_representation
    from repro_torch.device import resolve_device
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.engine import (
        _presolve_groups,
        _schedule_kwargs,
        build_compute_graph,
        build_task_graph,
    )

    dev = resolve_device(next((a for a in argv if not a.startswith("--")), None))
    if "--atomics" in argv:
        sdp_mod._make_device_ops = _atomic_ops(sdp_mod._make_device_ops)
    scs = [get_scenario(n).with_seed(s) for n in ("ring_uniform", "torus_cluster")
           for s in range(3)] + [get_scenario("ring_async"), get_scenario("torus_cluster_async")]
    t0 = time.perf_counter()
    groups = [_presolve_groups(scs, True, dev) for _ in range(2)]
    print(f"device {dev}, {'index_add_' if '--atomics' in argv else 'segment'} sums: two "
          f"batched presolves of {len(scs)} scenarios in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for sc in scs:
        key = (sc.name, sc.seed, True)
        kw = _schedule_kwargs(sc, True)
        rng = np.random.default_rng(sc.seed)
        tg = build_task_graph(sc, rng)
        cg, _ = build_compute_graph(sc, rng)
        build = (build_factored_bqp if _pick_representation(tg, cg, "auto") == "factored"
                 else build_bqp)
        alone = [solve_sdp(build(tg, cg), kw["sdp_options"], device=dev) for _ in range(2)]
        lanes = [g[key]["sol"] for g in groups]
        Yb, Ya = [s.Y_device for s in lanes], [s.Y_device for s in alone]
        sched = {}
        for label, cache in (("batch", groups[0][key]), ("alone", None)):
            out = compare_methods(tg, cg, ("sdp",), _sdp_cache=dict(cache) if cache else None,
                                  device=dev, **kw)
            sched[label] = out["sdp"]
        same_a = np.array_equal(sched["batch"].assignment, sched["alone"].assignment)
        print(f"{sc.name} seed {sc.seed} (batch {lanes[0].stats.get('batch')}, "
              f"{lanes[0].stats['constraint_kind']}): batches bit-equal "
              f"{bool(torch.equal(Yb[0], Yb[1]))}, alones bit-equal "
              f"{bool(torch.equal(Ya[0], Ya[1]))}, max |Y batch - Y alone| "
              f"{float(torch.max(torch.abs(Yb[0] - Ya[0]))):.3g}; iterations "
              f"{lanes[0].iterations} / {alone[0].iterations}; sdp bottleneck batch "
              f"{sched['batch'].bottleneck:.6f}, alone {sched['alone'].bottleneck:.6f}, same "
              f"assignment {same_a}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
