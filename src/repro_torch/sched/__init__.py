"""Classical scheduling baselines (HEFT family + simple heuristics), numpy
copies of ``repro.sched`` that ``compare_methods`` sets the SDP against."""

from repro_torch.sched.baselines import (
    greedy_bottleneck_assignment,
    local_search_refine,
    random_assignment,
    round_robin_assignment,
    sorted_assignment,
)
from repro_torch.sched.heft import build_heft_dag, heft_assignment
from repro_torch.sched.tp_heft import tp_heft_assignment

__all__ = [
    "build_heft_dag",
    "greedy_bottleneck_assignment",
    "heft_assignment",
    "local_search_refine",
    "random_assignment",
    "round_robin_assignment",
    "sorted_assignment",
    "tp_heft_assignment",
]
