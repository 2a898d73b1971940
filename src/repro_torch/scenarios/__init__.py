"""Declarative scenario engine on the port: topology × heterogeneity ×
dynamics sweeps (counterpart of ``repro.scenarios``).

A scenario composes four axes — task-graph family, machine profile, delay
model, scheduler set — plus an optional gossip-FL workload or churn trace
(trace-driven fleet dynamics with per-policy regret vs an oracle
re-solve), and runs them through one generate → schedule → simulate →
record pipeline on the port's scheduler, event engine and FL runners.
Paper figures (fig4/fig5/fig6) are presets over the same engine;
``python -m repro_torch.scenarios`` is the CLI.  ``run_scenario`` and
``run_sweep`` run on the CUDA card unless given ``device="cpu"``.
"""

from repro_torch.scenarios.engine import (
    build_compute_graph,
    build_task_graph,
    run_scenario,
    run_sweep,
)
from repro_torch.scenarios.profiles import (
    CHURN_MODELS,
    DELAY_MODELS,
    MACHINE_PROFILES,
    ChurnTrace,
    DelayDrift,
    churn_trace,
    delay_matrix,
    drifting_delays,
    machine_speeds,
)
from repro_torch.scenarios.spec import (
    CHURN_POLICIES,
    FLWorkload,
    Scenario,
    get_scenario,
    list_scenarios,
    register,
)

__all__ = [
    "CHURN_MODELS",
    "CHURN_POLICIES",
    "ChurnTrace",
    "DELAY_MODELS",
    "DelayDrift",
    "FLWorkload",
    "MACHINE_PROFILES",
    "Scenario",
    "build_compute_graph",
    "build_task_graph",
    "churn_trace",
    "delay_matrix",
    "drifting_delays",
    "get_scenario",
    "list_scenarios",
    "machine_speeds",
    "register",
    "run_scenario",
    "run_sweep",
]
