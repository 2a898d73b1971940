"""Scenario = topology × machine profile × delay model × schedulers (+ FL).

A :class:`Scenario` is a declarative, frozen description of one experiment
on the bottleneck-time pipeline: which task-graph family to generate
(``core/graphs.py`` topology families), how heterogeneous the machines
are, how delays are structured (possibly time-varying), which schedulers
compete, and optionally a gossip-FL workload to train on the stacked
engine.  ``repro_torch.scenarios.engine.run_scenario`` turns one into a
JSON-serializable record; the registry maps preset names (``fig4_nt10``,
``fig6``, ``torus_cluster``, ...) to scenarios so paper figures and new
sweeps share one code path.

A copy of ``repro.scenarios.spec`` on the port's topology families,
scheduler methods, staleness weights and event engine: the same fields,
the same validation and the same exception types.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.graphs import TOPOLOGY_FAMILIES
from repro_torch.core.scheduler import METHODS
from repro_torch.fl.staleness import StalenessWeights
from repro_torch.scenarios.profiles import (
    CHURN_MODELS,
    CHURN_TRACE_PARAMS,
    DELAY_MODELS,
    MACHINE_PROFILES,
    _take,
)
from repro_torch.sim import SEMANTICS, ExecutionSpec

_EXECUTION_PARAM_KEYS = (
    "jitter_sigma", "straggler_prob", "straggler_factor",
    "token_capacity", "token_refill",
)

# Churn policies are NOT plain scheduler methods — they are strategies for
# reacting to trace events, each anchored on a method:
#   - ``sdp_elastic``: warm-started ElasticScheduler re-solves at every
#     fleet/link transition, with heft fallback under the solve budget.
#   - ``sdp_static``:  one initial SDP solve; on fleet changes only the
#     orphaned tasks are greedily repaired (no re-solve) — the "do
#     nothing clever" lower bar.
#   - ``heft``:        full combinatorial heft re-solve at every event —
#     cheap, always converges, but never benefits from the SDP rounding.
CHURN_POLICIES = ("sdp_elastic", "sdp_static", "heft")

# ``churn_params`` keys that configure the sdp_elastic POLICY (degraded
# mode budgets) rather than the trace generator — split off before the
# params reach ``churn_trace``.
CHURN_POLICY_KEYS = (
    "fallback", "solve_timeout", "solver_max_iters", "require_converged",
)


@dataclasses.dataclass(frozen=True)
class FLWorkload:
    """Optional gossip-FL training riding on a scenario.

    ``paper_setting=True`` delegates instance generation AND scheduling to
    ``repro_torch.fl.runner.run_fl`` (the §4.2 code path — exactly what the fig6
    benchmark ran before the scenario engine existed): the scenario's
    ``degree_low``/``degree_high`` topology params are forwarded, but its
    ``machine_params``/``delay_params``/``schedule_params`` are NOT — the
    legacy path's homogeneous machines, Unif(0,1) delays, and default
    solver budgets are what make it bit-identical to the pre-engine fig6.
    Otherwise the engine's (task graph, compute graph, schedules) drive
    the trainer.
    """

    dataset: str = "mnist"
    rounds: int = 3
    local_steps: int = 2
    batch_size: int = 32
    num_samples: int = 1024
    backend: str = "stacked"
    paper_setting: bool = False
    # Barrier-free training (execution="async" scenarios): ring-buffer
    # depth of the AsyncGossipTrainer's message archive — snapshots older
    # than this many rounds are evicted and their edges fall back to
    # self-weight (DESIGN.md §11).
    archive_depth: int = 8


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point of the topology × heterogeneity × dynamics grid.

    ``topology_params`` / ``machine_params`` / ``delay_params`` are passed
    through to the corresponding generator (see ``core/graphs.py`` and
    ``scenarios/profiles.py`` for the accepted keys); ``schedule_params``
    tunes the scheduler call (``num_samples``, ``max_iters``).
    ``reschedule_every`` only matters for the ``drift`` delay model: the
    engine refreshes C and offers a warm-started re-schedule every that
    many rounds (``ElasticScheduler.on_delay_update``).

    ``execution`` picks the event-engine semantics the scenario is
    simulated under (``repro_torch.sim``): ``sync`` (Eq. 2 round barrier —
    the default, and the only semantics compatible with ``drift`` /
    failure control events), ``overlap`` (send/compute pipelining), or
    ``async`` (barrier-free; records staleness + steady-state
    throughput).  ``execution_params`` feeds the per-machine
    perturbation model (``jitter_sigma``, ``straggler_prob``,
    ``straggler_factor`` — scalars or per-machine sequences).  Under
    the ``drift`` delay model with perturbations the engine's measured
    busy times are additionally fed to
    ``ElasticScheduler.observe_round`` after every round, closing the
    elastic speed-estimation loop (static scenarios have no
    ElasticScheduler in the loop — they record the noisy timings as
    measured).
    """

    name: str
    topology: str
    num_tasks: int
    num_machines: int = 4
    machine_profile: str = "uniform"
    delay_model: str = "uniform"
    schedulers: tuple[str, ...] = ("sdp", "heft", "tp_heft", "random")
    rounds: int = 8
    seed: int = 0
    reschedule_every: int = 4
    execution: str = "sync"
    execution_params: Mapping = dataclasses.field(default_factory=dict)
    topology_params: Mapping = dataclasses.field(default_factory=dict)
    machine_params: Mapping = dataclasses.field(default_factory=dict)
    delay_params: Mapping = dataclasses.field(default_factory=dict)
    schedule_params: Mapping = dataclasses.field(default_factory=dict)
    fl: FLWorkload | None = None
    # -- churn axis ---------------------------------------------------------
    # A churn model name activates trace-driven fleet dynamics: a seeded
    # ChurnTrace (stream (seed, 2)) drives fail/join/recover/link events
    # through the sync engine, each churn policy reacts per its strategy,
    # and the record carries bottleneck-time regret vs an oracle per-event
    # cold re-solve.  Mutually exclusive with drift delays and FL (one
    # record = one dynamics regime).
    churn: str | None = None
    churn_params: Mapping = dataclasses.field(default_factory=dict)
    churn_policies: tuple[str, ...] = CHURN_POLICIES
    # Staleness-weight family for barrier-free FL (``repro_torch.fl.staleness``
    # keys: kind/a/b).  Only meaningful with fl + execution="async" —
    # under sync every mix is fresh, so s(Δτ) never fires.
    staleness_params: Mapping = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.topology not in TOPOLOGY_FAMILIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; "
                f"choose from {TOPOLOGY_FAMILIES}"
            )
        if self.machine_profile not in MACHINE_PROFILES:
            raise ValueError(
                f"unknown machine profile {self.machine_profile!r}; "
                f"choose from {MACHINE_PROFILES}"
            )
        if self.delay_model not in DELAY_MODELS:
            raise ValueError(
                f"unknown delay model {self.delay_model!r}; "
                f"choose from {DELAY_MODELS}"
            )
        for m in self.schedulers:
            if m not in METHODS:
                raise ValueError(f"unknown scheduler {m!r}; choose from {METHODS}")
        if self.num_tasks < 2 or self.num_machines < 2:
            raise ValueError("need >= 2 tasks and >= 2 machines")
        if self.execution not in SEMANTICS:
            raise ValueError(
                f"unknown execution semantics {self.execution!r}; "
                f"choose from {SEMANTICS}"
            )
        unknown = set(self.execution_params) - set(_EXECUTION_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown execution parameter(s) {sorted(unknown)}; "
                f"accepted: {sorted(_EXECUTION_PARAM_KEYS)}"
            )
        self.execution_spec()  # validate parameter values eagerly
        if (
            self.execution_params.get("token_capacity") is not None
            and self.execution != "async"
        ):
            raise ValueError(
                f"execution_params['token_capacity'] requires "
                f"execution='async' (got execution={self.execution!r}): "
                f"under sync/overlap every send is a dependency, so a "
                f"skipped send would deadlock its consumer; nearest legal "
                f"config: execution='async', or drop token_capacity"
            )
        if self.delay_model == "drift" and self.execution != "sync":
            raise ValueError(
                f"delay_model='drift' requires execution='sync' (got "
                f"execution={self.execution!r}): drift re-schedules at "
                f"round barriers, which barrier-free semantics do not "
                f"have; nearest legal config: execution='sync', or "
                f"delay_model='distance' with execution={self.execution!r}"
            )
        if self.fl is not None and self.execution == "overlap":
            raise ValueError(
                f"fl with execution='overlap' is not supported: the "
                f"pipelined engine overlaps sends with compute but still "
                f"consumes every input fresh, which no trainer models; "
                f"nearest legal config: execution='sync' "
                f"(GossipTrainer barriers) or execution='async' "
                f"(AsyncGossipTrainer on delivered snapshots)"
            )
        if self.fl is not None and self.delay_model == "drift":
            raise ValueError(
                "an FL workload cannot ride on the drift delay model: the "
                "FL timeline assumes static delays, so one record would "
                "describe two different runs"
            )
        if (
            self.fl is not None
            and self.fl.paper_setting
            and self.execution != "sync"
        ):
            raise ValueError(
                f"fl.paper_setting=True with execution={self.execution!r} "
                f"is not supported: the paper_setting path replays the "
                f"legacy synchronous §4.2 benchmark bit-for-bit; nearest "
                f"legal config: execution='sync', or paper_setting=False "
                f"for barrier-free training on the engine's instance"
            )
        if self.staleness_params and (
            self.fl is None or self.execution != "async"
        ):
            raise ValueError(
                f"staleness_params only apply to barrier-free FL training "
                f"(got fl={'set' if self.fl is not None else None}, "
                f"execution={self.execution!r}): under sync every mix is "
                f"fresh, so s(Δτ) never fires; nearest legal config: "
                f"execution='async' with an fl workload, or drop "
                f"staleness_params"
            )
        # Validate the family eagerly — a bad kind/a/b must fail at
        # construction, not when the trainer first mixes.
        StalenessWeights(**dict(self.staleness_params))
        if self.churn is not None:
            if self.churn not in CHURN_MODELS:
                raise ValueError(
                    f"unknown churn model {self.churn!r}; "
                    f"choose from {CHURN_MODELS}"
                )
            if self.fl is None and self.execution != "sync":
                raise ValueError(
                    f"churn={self.churn!r} without an fl workload requires "
                    f"execution='sync' (got execution={self.execution!r}): "
                    f"the churn policies re-schedule at round barriers; "
                    f"nearest legal config: execution='sync', or add an fl "
                    f"workload with execution='async' for barrier-free "
                    f"churn-tolerant training"
                )
            if self.fl is not None and self.execution != "async":
                raise ValueError(
                    f"churn={self.churn!r} composed with fl requires "
                    f"execution='async' (got execution={self.execution!r}): "
                    f"only the barrier-free AsyncGossipTrainer freezes and "
                    f"recovers replicas mid-training; nearest legal config: "
                    f"execution='async', or drop fl to run the sync churn "
                    f"policies"
                )
            if self.delay_model == "drift":
                raise ValueError(
                    "churn and drift are separate dynamics axes; compose "
                    "link outages via churn_params instead of drift delays"
                )
            if not self.churn_policies:
                raise ValueError("churn scenarios need >= 1 churn policy")
            # Validate parameter NAMES eagerly — a misspelled churn knob
            # must fail at construction, not mid-sweep.  Policy keys
            # (solver budgets) ride in churn_params but never reach the
            # trace generator.
            trace_params = {
                k: v for k, v in self.churn_params.items()
                if k not in CHURN_POLICY_KEYS
            }
            _take(self.churn, trace_params, CHURN_TRACE_PARAMS[self.churn])
            if self.fl is not None and int(
                trace_params.get("link_outages", 0)
            ) != 0:
                raise ValueError(
                    f"churn_params['link_outages']="
                    f"{trace_params['link_outages']} cannot compose with "
                    f"fl: link events are a sync-only control kind (the "
                    f"async engine has no barrier at which to swap the "
                    f"delay matrix); nearest legal config: "
                    f"link_outages=0, or drop fl for the sync churn "
                    f"policies"
                )
            for pol in self.churn_policies:
                if pol not in CHURN_POLICIES:
                    raise ValueError(
                        f"unknown churn policy {pol!r}; "
                        f"choose from {CHURN_POLICIES}"
                    )

    def with_seed(self, seed: int) -> "Scenario":
        return dataclasses.replace(self, seed=seed)

    def execution_spec(self) -> ExecutionSpec:
        """The event-engine spec this scenario simulates under.

        Jitter/straggler draws are a pure function of the scenario seed,
        but through a DERIVED stream ``(seed, 1)`` — reusing the bare
        seed would replay the exact PRNG variates that generated the
        instance (speeds, delays, topology), correlating the execution
        noise with the heterogeneity it is supposed to perturb.
        """
        params = {
            k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in self.execution_params.items()
        }
        return ExecutionSpec(
            semantics=self.execution, seed=(self.seed, 1), **params
        )

    def staleness_weights(self) -> StalenessWeights:
        """The validated ``s(Δτ)`` family for barrier-free FL training
        (the constant family — no discount — when unset)."""
        return StalenessWeights(**dict(self.staleness_params))

    def axes(self) -> dict:
        """The scenario's grid coordinates (for sweep records / --list)."""
        return {
            "topology": self.topology,
            "num_tasks": self.num_tasks,
            "num_machines": self.num_machines,
            "machine_profile": self.machine_profile,
            "delay_model": self.delay_model,
            "schedulers": list(self.schedulers),
            "execution": self.execution,
            "fl": self.fl is not None,
            "churn": self.churn,
            "churn_policies": (
                list(self.churn_policies) if self.churn is not None else []
            ),
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Register a scenario under its name (last registration wins)."""
    _REGISTRY[scenario.name] = scenario
    return scenario


def _ensure_presets_loaded() -> None:
    from repro_torch.scenarios import presets  # noqa: F401  (registers on import)


def get_scenario(name: str) -> Scenario:
    _ensure_presets_loaded()
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}")
    return _REGISTRY[name]


def list_scenarios() -> dict[str, Scenario]:
    _ensure_presets_loaded()
    return dict(sorted(_REGISTRY.items()))
