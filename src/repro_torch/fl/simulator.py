"""Execution time of one gossip round on networked machines (numpy copy of
``repro.fl.simulator.round_time``).

The bottleneck time of a round under an assignment is the paper's Eq. (2)
(``repro_torch.core.bqp.task_times``).  ``repro``'s multi-round
``timeline`` drives its discrete-event engine (``repro.sim``), which is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bqp import task_times
from repro_torch.core.graphs import ComputeGraph, TaskGraph


def round_time(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    assignment: np.ndarray,
    overlap: bool = False,
) -> float:
    t_comp, t_comm = task_times(task_graph, compute_graph, assignment)
    if overlap:
        return float(np.max(np.maximum(t_comp, t_comm)))
    return float(np.max(t_comp + t_comm))
