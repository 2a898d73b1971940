"""Core of the paper on the CUDA card: bottleneck-time-minimizing task
scheduling via SDP (counterpart of ``repro.core``, single-instance path)."""

from repro_torch.core.bqp import (
    BQPData,
    FactoredBQP,
    bottleneck_time,
    bottleneck_time_batch,
    brute_force_optimum,
    build_bqp,
    build_factored_bqp,
    dense_bytes_estimate,
)
from repro_torch.core.graphs import (
    ComputeGraph,
    TaskGraph,
    gossip_task_graph,
    random_compute_graph,
    random_task_graph,
)
from repro_torch.core.rounding import (
    RoundingResult,
    analysis_bounds,
    expected_bottleneck,
    naive_rounding,
    optimal_upper_bound,
    randomized_rounding,
    sdp_lower_bound,
)
from repro_torch.core.scheduler import (
    METHODS,
    REPRESENTATIONS,
    Schedule,
    clear_warm_start,
    compare_methods,
    get_warm_start,
    schedule,
    seed_warm_start,
)
from repro_torch.core.sdp import SDPOptions, SDPSolution, solve_sdp

__all__ = [
    "BQPData",
    "ComputeGraph",
    "FactoredBQP",
    "METHODS",
    "REPRESENTATIONS",
    "RoundingResult",
    "SDPOptions",
    "SDPSolution",
    "Schedule",
    "TaskGraph",
    "analysis_bounds",
    "bottleneck_time",
    "bottleneck_time_batch",
    "brute_force_optimum",
    "build_bqp",
    "build_factored_bqp",
    "clear_warm_start",
    "compare_methods",
    "dense_bytes_estimate",
    "expected_bottleneck",
    "get_warm_start",
    "gossip_task_graph",
    "naive_rounding",
    "optimal_upper_bound",
    "random_compute_graph",
    "random_task_graph",
    "randomized_rounding",
    "schedule",
    "sdp_lower_bound",
    "seed_warm_start",
    "solve_sdp",
]
