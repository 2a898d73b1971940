"""How far gossip FL runs part over 3 rounds when nothing re-syncs them:
the stacked trainer, the async trainer on fresh versions, and the async
trainer on ``chip_smoke.py`` phase 17 (b)'s churned delivery record.

    python3 scripts/async_drift.py          # the card against the CPU
    python3 scripts/async_drift.py --cpu    # the CPU against itself

On the card: each run at MNIST and CIFAR-10 width, then the record at MNIST
width with cuDNN's deterministic algorithms and with cuDNN off.  With
``--cpu`` (no card needed): the CPU against a second CPU run whose initial
replicas carry relative noise of 2^-23 (about one float32 ulp), at MNIST
width.  Each line is a run's per-round relative loss difference.  Both
modes end with the record at MNIST width user by user: each round and each
user, up or down, the user's valid incoming edges and their summed weight
(the nonzero entries and the sum of its row of the mixing matrix), the
relative difference of its replica between the two runs, and the entries
its message picks in one run only.  Phase 17 (b) holds the card to the CPU
one round at a time from a shared state; this script shows what happens
without that.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.core import compare_methods  # noqa: E402
from repro_torch.data import image_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl import (  # noqa: E402
    AsyncGossipTrainer,
    GossipConfig,
    GossipTrainer,
    init_cnn_params,
)
from repro_torch.train import TopK  # noqa: E402

ROUNDS = 3
CFG = GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05))


def trainer(kind, data, where, tg, perturb=False):
    """A trainer of ``kind`` (stacked, or async for fresh and record) on
    1,280 samples of ``data``; ``perturb`` scales its replicas by
    1 + 2^-23·N(0, 1)."""
    train, _ = image_dataset(data, 1280, seed=0)
    shards = train.split(10, np.random.default_rng(0))
    shape = (28, 28, 1) if data == "mnist" else (32, 32, 3)

    def init(g):
        return init_cnn_params(g, shape)

    tr = (GossipTrainer(tg, init, shards, CFG, seed=0, device=where) if kind == "stacked" else
          AsyncGossipTrainer(tg, init, shards, CFG, seed=0, staleness=cs.hinge(), device=where))
    if perturb:
        with torch.no_grad():
            flat = tr._blocks[0].model.flat
            noise = torch.randn(flat.shape, generator=torch.Generator().manual_seed(0))
            flat.mul_(1 + 2.0**-23 * noise.to(flat.device))
    return tr


def step(tr, kind, plan, r):
    if kind != "record":
        return tr.step_round()["mean_loss"]
    active, versions = plan[r]
    return tr.step_round(active=active, edge_versions=versions)["mean_loss"]


def by_user(pair, plan, label) -> None:
    """The churned record at MNIST width, two runs side by side, user by user."""
    for r, (active, versions) in enumerate(plan):
        for tr in pair:
            tr.step_round(active=active, edge_versions=versions)
        one, two = ([t.cpu() for t in (tr._blocks[0].model.flat.detach(), tr._M,
                                       tr.archive[r % tr.archive_depth])] for tr in pair)
        diff = (one[0] - two[0]).norm(dim=1) / two[0].norm(dim=1)
        flips = ((one[2] != 0) != (two[2] != 0)).sum(dim=1)
        for u in range(len(active)):
            row = two[1][u]
            print(f"drift by user, {label}: round {r} user {u} {'up' if active[u] else 'down'}: "
                  f"valid incoming edges {int((row != 0).sum())}, weight {float(row.sum()):.4f}; "
                  f"replica relative difference {float(diff[u]):.3g}; message entries picked "
                  f"in one run only {int(flips[u]) if active[u] else 0}", flush=True)


def main() -> int:
    on_cpu = "--cpu" in sys.argv[1:]
    dev = torch.device("cpu") if on_cpu else resolve_device(None)
    tg, cg = cs.fl_instance(10)
    sch = compare_methods(tg, cg, ("heft",), device="cpu")
    _, events = cs.churn_events(sch)
    _, plan = cs.record_rounds(tg, cg, sch["heft"].assignment, ROUNDS, events)
    label = "cpu against perturbed cpu" if on_cpu else "card against cpu"

    def line(note, kind, data):
        pair = [trainer(kind, data, dev, tg), trainer(kind, data, "cpu", tg, perturb=on_cpu)]
        losses = [[step(tr, kind, plan, r) for r in range(ROUNDS)] for tr in pair]
        print(f"drift {kind} {data}{note}: relative loss differences {label} "
              f"{[float('%.3g' % (abs(x - y) / abs(y))) for x, y in zip(*losses)]}",
              flush=True)

    if not on_cpu:
        print(f"nvidia-smi: {cs.smi()}", flush=True)
    runs = [("stacked", "mnist"), ("fresh", "mnist"), ("record", "mnist")]
    if not on_cpu:
        runs += [("stacked", "cifar10"), ("record", "cifar10")]
    for kind, data in runs:
        line("", kind, data)
    if not on_cpu:
        torch.backends.cudnn.deterministic = True
        line(", cudnn deterministic", "record", "mnist")
        torch.backends.cudnn.enabled = False
        line(", cudnn off", "record", "mnist")
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
    by_user([trainer("record", "mnist", dev, tg),
             trainer("record", "mnist", "cpu", tg, perturb=on_cpu)], plan, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
