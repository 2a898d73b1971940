"""Carry state across from the JAX package as plain numpy arrays.

Nothing here imports ``repro``: the caller hands over arrays.

  - ``instance_from_arrays(p, edges, e, C)`` rebuilds an instance;
  - ``warm_start_from_arrays({"w": ..., "V": ...})`` turns a ``repro``
    ``SDPSolution.state`` into the port's ``solve_sdp(warm_start=...)``
    payload (the same layout: DR iterate w over (vec(Y), t, s) and, when
    present, the tracked eigenbasis V).

A solved ``Y`` passes as the plain array it already is
(``randomized_rounding(..., Y)``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import ComputeGraph, TaskGraph


def instance_from_arrays(p, edges, e, C) -> tuple[TaskGraph, ComputeGraph]:
    """(TaskGraph, ComputeGraph) from work p, (i, j) edges, speeds e, delays C."""
    task_graph = TaskGraph(
        p=np.asarray(p, dtype=np.float64),
        edges=tuple((int(i), int(j)) for (i, j) in edges),
    )
    return task_graph, ComputeGraph(e=np.asarray(e), C=np.asarray(C))


def warm_start_from_arrays(state: dict) -> dict:
    """``{"w": (dim,), "V": (n+1, k) or absent}`` -> the port's warm start."""
    out = {"w": np.asarray(state["w"], dtype=np.float64)}
    if state.get("V") is not None:
        out["V"] = np.asarray(state["V"], dtype=np.float64)
    return out
