"""Pilot phase (paper §4.2): estimate task work ``p`` before scheduling
(a copy of ``repro.fl.pilot``).

Each user trains on a small pilot slice of its data on a reference
machine; measured wall-clock × machine speed gives the work estimate.
For LM replicas the analytic FLOPs module provides ``p`` directly
(``repro_torch.models.flops``, through ``lm_task_work``) — both paths feed
the same scheduler.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def measure_task_work(
    run_pilot: Callable[[int], None],
    num_tasks: int,
    reference_speed: float = 1.0,
    repeats: int = 1,
) -> np.ndarray:
    """Time ``run_pilot(i)`` per task -> work units p_i = t_i · e_ref."""
    p = np.zeros(num_tasks)
    for i in range(num_tasks):
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_pilot(i)
            best = min(best, time.perf_counter() - t0)
        p[i] = best * reference_speed
    return p


def lm_task_work(cfg, local_steps: int, tokens_per_step: int) -> float:
    """Analytic work of one gossip round of LM training (FLOPs)."""
    from repro_torch.models.flops import param_counts

    counts = param_counts(cfg)
    return 6.0 * counts.active * tokens_per_step * local_steps


def stacked_task_work(
    round_seconds: float,
    shard_sizes: "np.ndarray | list[int]",
    reference_speed: float = 1.0,
) -> np.ndarray:
    """Per-user work estimates from ONE fused stacked-round timing.

    The stacked gossip engine runs every user's local steps as one batched
    computation, so users cannot be timed individually the way
    ``measure_task_work`` does.  Instead the measured round wall-clock is
    apportioned by shard size — local-step work is proportional to samples
    processed, and the paper's §4.2 setting splits data evenly, so this
    reduces to the uniform ``p`` the FL runner uses.
    """
    sizes = np.asarray(shard_sizes, dtype=np.float64)
    if np.any(sizes <= 0):
        raise ValueError("shard sizes must be positive")
    return round_seconds * reference_speed * sizes / sizes.sum()


def ema_update(current: np.ndarray, observed: np.ndarray, alpha: float = 0.3):
    """Straggler tracking: blend observed speeds into the compute graph."""
    return (1 - alpha) * current + alpha * observed
