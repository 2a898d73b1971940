"""The spread of ``schedule(method="sdp")``'s bottleneck over rounding seeds
at a fig4 scaling size, for the port's device path and its float64 host
path.

    python3 scripts/fig4_seed_spread.py [n_t] [instances] [seeds] [device]

On ``paper_instance(i, n_t)`` (``benchmarks/common.py``'s §4.1.2 draw,
N_K = 4) for i < ``instances``, with ``benchmarks/fig4_tasks.py``'s budget
``clip(60000 // n, 80, 1500)`` iterations (n = 4·n_t), ``check_every=10``
and 2048 samples, each rounding seed s < ``seeds`` schedules once on the
device path (``device``: "cuda" by default, or "cpu") and once with
``solver_backend="numpy", rounding_backend="numpy"``.  Prints every
bottleneck (host float64 Eq. 2), the mean of each path, and TP-HEFT's and
HEFT's bottleneck beside.  A single seed's best-of-2048 sample varies by
tens of percent between nearby covariances, so one seed does not compare
the two paths.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    SDPOptions,
    random_compute_graph,
    random_task_graph,
    schedule,
)


def main(argv: list[str]) -> int:
    n_t = int(argv[0]) if argv else 32
    instances = int(argv[1]) if len(argv) > 1 else 3
    seeds = int(argv[2]) if len(argv) > 2 else 4
    device = argv[3] if len(argv) > 3 else "cuda"
    for i in range(instances):
        rng = np.random.default_rng(i)
        tg = random_task_graph(rng, n_t, degree_low=2, degree_high=4)
        cg = random_compute_graph(rng, 4)
        iters = int(np.clip(60_000 // (4 * n_t), 80, 1500))
        opts = SDPOptions(max_iters=iters, check_every=10)
        got: dict[str, list[float]] = {"device": [], "host": []}
        for s in range(seeds):
            got["device"].append(schedule(tg, cg, "sdp", seed=s, num_samples=2048,
                                          sdp_options=opts, device=device).bottleneck)
            got["host"].append(schedule(tg, cg, "sdp", seed=s, num_samples=2048,
                                        sdp_options=opts, solver_backend="numpy",
                                        rounding_backend="numpy", device=device).bottleneck)
        base = {m: schedule(tg, cg, m, device=device).bottleneck for m in ("heft", "tp_heft")}
        print(f"fig4 spread n_t={n_t} instance {i} ({iters} iterations, device {device}): "
              + "; ".join(f"{k} mean {np.mean(v):.4f} {[round(x, 4) for x in v]}"
                          for k, v in got.items())
              + f"; heft {base['heft']:.4f}, tp_heft {base['tp_heft']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
