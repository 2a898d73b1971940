"""Registered scenario presets: paper figures + new grid combinations.

A verbatim copy of ``repro.scenarios.presets``' registrations (the same
names, fields and parameters), registered in the port's own registry.

Importing this module populates the registry (``spec.get_scenario`` /
``spec.list_scenarios`` trigger the import lazily).  Three groups:

  - ``fig4_nt{N}`` / ``fig5_deg{L}_{H}`` — the paper's §4.1.2 sweeps as
    single-seed scenarios.  Generation consumes the rng exactly like
    ``benchmarks.common.paper_instance``, so per-seed bottlenecks match
    the pre-engine figure benchmarks; the benchmarks loop seeds via
    ``Scenario.with_seed`` and average.
  - ``fig6`` — the §4.2 gossip-FL experiment; ``FLWorkload.paper_setting``
    delegates instance generation to ``repro_torch.fl.runner.run_fl`` so the learning
    curve is bit-identical to the legacy fig6 path.
  - New combinations (``NEW_COMBINATIONS``) — one scenario per distinct
    topology family crossed with heterogeneity and delay structure,
    including a delay-drift run with mid-run re-scheduling and a gossip-FL
    workload on a small-world graph.
  - Event-engine combinations (``ASYNC_COMBINATIONS``) — the same grid
    replayed under non-barrier execution semantics (``repro_torch.sim``):
    ``async`` scenarios record staleness + steady-state throughput next
    to the sync ``predicted_bottleneck``, and one ``overlap`` scenario
    records the pipelined period.
  - Churn combinations (``CHURN_COMBINATIONS``) — trace-driven fleet
    dynamics (Markov flapping, Weibull sessions, intermittent links,
    and one preset with an injected zero solve budget that forces the
    elastic policy through its heft fallback), each comparing
    ``sdp_elastic`` / ``sdp_static`` / ``heft`` against an oracle
    per-event cold re-solve.

``python -m repro_torch.scenarios`` sweeps any of them on the card
(``--device cpu`` on the host).
"""

from __future__ import annotations

from repro_torch.scenarios.spec import FLWorkload, Scenario, register

PAPER_SCHEDULERS = ("heft", "tp_heft", "sdp_naive", "sdp", "sdp_ls")
DEFAULT_SCHEDULERS = ("sdp", "heft", "tp_heft", "random")

# -- paper figure presets ----------------------------------------------------

FIG4_SIZES = (5, 10, 15, 20, 25, 30)
for _n in FIG4_SIZES:
    register(Scenario(
        name=f"fig4_nt{_n}",
        topology="random",
        num_tasks=_n,
        num_machines=4,
        machine_profile="paper",
        delay_model="paper",
        schedulers=PAPER_SCHEDULERS,
        topology_params={"degree_low": 2, "degree_high": 4},
    ))

FIG5_DEGREES = ((2, 4), (4, 6), (6, 8), (8, 10))
for (_dl, _dh) in FIG5_DEGREES:
    register(Scenario(
        name=f"fig5_deg{_dl}_{_dh}",
        topology="random",
        num_tasks=21,
        num_machines=4,
        machine_profile="paper",
        delay_model="paper",
        schedulers=PAPER_SCHEDULERS,
        topology_params={"degree_low": _dl, "degree_high": _dh},
    ))

FIG6 = register(Scenario(
    name="fig6",
    topology="gossip",
    num_tasks=10,
    num_machines=4,
    machine_profile="uniform",
    delay_model="uniform",
    schedulers=("heft", "tp_heft", "sdp_naive", "sdp"),
    topology_params={"degree_low": 6, "degree_high": 7},
    fl=FLWorkload(
        dataset="mnist", rounds=3, local_steps=2, batch_size=32,
        num_samples=1024, backend="stacked", paper_setting=True,
    ),
))

# -- new topology × heterogeneity × dynamics combinations --------------------

NEW_COMBINATIONS = (
    # Baseline structured topology on a homogeneous fleet.
    register(Scenario(
        name="ring_uniform",
        topology="ring",
        num_tasks=12,
        num_machines=4,
        machine_profile="uniform",
        delay_model="uniform",
        schedulers=DEFAULT_SCHEDULERS,
    )),
    # 4x4 torus across two datacenter racks with a few fast machines.
    register(Scenario(
        name="torus_cluster",
        topology="torus",
        num_tasks=16,
        num_machines=6,
        machine_profile="bimodal",
        delay_model="cluster",
        schedulers=DEFAULT_SCHEDULERS,
        topology_params={"rows": 4},
        machine_params={"fast": 4.0, "slow": 1.0, "fast_fraction": 0.34},
        delay_params={"clusters": 2, "intra": 0.1, "inter": 1.0},
    )),
    # Sparse random gossip over geographically spread edge devices.
    register(Scenario(
        name="er_bimodal_distance",
        topology="erdos_renyi",
        num_tasks=16,
        num_machines=4,
        machine_profile="bimodal",
        delay_model="distance",
        schedulers=DEFAULT_SCHEDULERS,
        topology_params={"edge_prob": 0.15, "p_sigma": 1.0},
    )),
    # Hub-dominated gossip on a long-tailed heterogeneous fleet.
    register(Scenario(
        name="scalefree_lognormal",
        topology="scale_free",
        num_tasks=20,
        num_machines=4,
        machine_profile="lognormal",
        delay_model="distance",
        schedulers=DEFAULT_SCHEDULERS,
        topology_params={"attach": 2},
        machine_params={"sigma": 0.75},
    )),
    # Small-world gossip under drifting network delays: re-schedule every
    # 4 rounds via the warm-started SDP cache.
    register(Scenario(
        name="smallworld_drift",
        topology="small_world",
        num_tasks=16,
        num_machines=4,
        machine_profile="uniform",
        delay_model="drift",
        schedulers=DEFAULT_SCHEDULERS,
        rounds=16,
        reschedule_every=4,
        topology_params={"k": 4, "rewire_prob": 0.2},
        delay_params={"base": "distance", "amplitude": 0.6, "period": 8.0},
    )),
    # Layered pipeline DAG on an edge/cloud split with clustered delays.
    register(Scenario(
        name="layered_cloud",
        topology="layered_dag",
        num_tasks=16,
        num_machines=4,
        machine_profile="bimodal",
        delay_model="cluster",
        schedulers=DEFAULT_SCHEDULERS,
        topology_params={"layers": 4, "edge_prob": 0.5, "p_sigma": 1.0},
        delay_params={"clusters": 2, "intra": 0.05, "inter": 0.8},
    )),
    # Gossip-FL training on a small-world topology with the engine's own
    # instance (exercises run_fl with an injected task/compute graph).
    register(Scenario(
        name="smallworld_fl",
        topology="small_world",
        num_tasks=8,
        num_machines=4,
        machine_profile="uniform",
        delay_model="uniform",
        schedulers=("heft", "tp_heft", "sdp"),
        topology_params={"k": 4, "rewire_prob": 0.1},
        fl=FLWorkload(
            dataset="mnist", rounds=2, local_steps=2, batch_size=32,
            num_samples=512, backend="stacked",
        ),
    )),
    # Hierarchical edge -> region gossip: dense intra-cluster exchange,
    # only cluster heads on the sparse global ring (the population-scale
    # topology the sharded engine partitions along, DESIGN.md §13).
    register(Scenario(
        name="cluster_hier",
        topology="cluster",
        num_tasks=24,
        num_machines=4,
        machine_profile="bimodal",
        delay_model="cluster",
        schedulers=DEFAULT_SCHEDULERS,
        topology_params={
            "clusters": 4, "inner_topology": "dense",
            "head_topology": "ring", "heads_per_cluster": 2,
        },
        delay_params={"clusters": 2, "intra": 0.1, "inter": 1.0},
    )),
)

# -- event-engine combinations: sync-vs-async/overlap on the same grids ------

ASYNC_SCHEDULERS = ("sdp", "heft", "tp_heft")

ASYNC_COMBINATIONS = (
    # Long-tailed fleet on a ring: barrier-free execution decouples the
    # round period from the slow links, staleness absorbs the delays.
    register(Scenario(
        name="ring_async",
        topology="ring",
        num_tasks=12,
        num_machines=4,
        machine_profile="lognormal",
        delay_model="uniform",
        schedulers=ASYNC_SCHEDULERS,
        rounds=24,
        execution="async",
        execution_params={"jitter_sigma": 0.1},
    )),
    # Edge/cloud torus across two racks — the bimodal speeds make the
    # fast machines run rounds ahead of the edge devices.
    register(Scenario(
        name="torus_cluster_async",
        topology="torus",
        num_tasks=16,
        num_machines=6,
        machine_profile="bimodal",
        delay_model="cluster",
        schedulers=ASYNC_SCHEDULERS,
        rounds=24,
        execution="async",
        topology_params={"rows": 4},
        machine_params={"fast": 4.0, "slow": 1.0, "fast_fraction": 0.34},
        delay_params={"clusters": 2, "intra": 0.1, "inter": 1.0},
        execution_params={"jitter_sigma": 0.1},
    )),
    # Hub-dominated gossip with stragglers: per-round 3x slowdowns hit
    # 10% of machine-rounds, the hub tasks accumulate staleness.
    register(Scenario(
        name="scalefree_async",
        topology="scale_free",
        num_tasks=20,
        num_machines=4,
        machine_profile="lognormal",
        delay_model="distance",
        schedulers=ASYNC_SCHEDULERS,
        rounds=24,
        execution="async",
        topology_params={"attach": 2},
        execution_params={
            "jitter_sigma": 0.15,
            "straggler_prob": 0.1,
            "straggler_factor": 3.0,
        },
    )),
    # Pipelined (overlap) execution on the small-world grid: sends of
    # round r overlap compute of r+1, the period drops below Eq. 2
    # without introducing staleness.
    register(Scenario(
        name="smallworld_overlap",
        topology="small_world",
        num_tasks=16,
        num_machines=4,
        machine_profile="lognormal",
        delay_model="distance",
        schedulers=ASYNC_SCHEDULERS,
        rounds=24,
        execution="overlap",
        topology_params={"k": 4, "rewire_prob": 0.2},
    )),
)

# -- barrier-free FL combinations: async training on the event engine --------

ASYNC_FL_COMBINATIONS = (
    # fig6-style gossip instance trained barrier-free under a straggler
    # profile: per-round 3x slowdowns hit 15% of machine-rounds, hinge
    # staleness weights discount the late snapshots.  The sync twin of
    # this preset (same instance, execution="sync") is what
    # benchmarks/async_fl_bench.py compares against at equal simulated
    # time.
    register(Scenario(
        name="gossip_async_fl",
        topology="gossip",
        num_tasks=10,
        num_machines=4,
        machine_profile="lognormal",
        delay_model="uniform",
        schedulers=("sdp", "heft"),
        execution="async",
        execution_params={
            "jitter_sigma": 0.1,
            "straggler_prob": 0.15,
            "straggler_factor": 3.0,
        },
        topology_params={"degree_low": 6, "degree_high": 7},
        staleness_params={"kind": "hinge", "a": 0.5, "b": 1},
        fl=FLWorkload(
            dataset="mnist", rounds=6, local_steps=2, batch_size=32,
            num_samples=1024,
        ),
    )),
    # Small-world users on an edge/cloud fleet: the bimodal speeds make
    # the cloud machines run rounds ahead, polynomial staleness decay
    # absorbs the version gap.
    register(Scenario(
        name="smallworld_async_fl",
        topology="small_world",
        num_tasks=8,
        num_machines=4,
        machine_profile="bimodal",
        delay_model="distance",
        schedulers=("sdp", "heft"),
        execution="async",
        execution_params={
            "jitter_sigma": 0.1,
            "straggler_prob": 0.1,
            "straggler_factor": 3.0,
        },
        topology_params={"k": 4, "rewire_prob": 0.1},
        machine_params={"fast": 4.0, "slow": 1.0, "fast_fraction": 0.25},
        staleness_params={"kind": "poly", "a": 0.5},
        fl=FLWorkload(
            dataset="mnist", rounds=6, local_steps=2, batch_size=32,
            num_samples=512,
        ),
    )),
    # Churn×FL: Markov flapping freezes replicas mid-training; the
    # barrier-free trainer recovers them via anti-entropy with bounded
    # in-flight sends.  Evidence target: finite losses, frozen-then-
    # recovered replicas, zero barrier stalls.
    register(Scenario(
        name="gossip_churn_fl",
        topology="gossip",
        num_tasks=10,
        num_machines=4,
        machine_profile="uniform",
        delay_model="uniform",
        schedulers=("sdp", "heft"),
        execution="async",
        execution_params={"token_capacity": 8.0, "token_refill": 4.0},
        topology_params={"degree_low": 6, "degree_high": 7},
        staleness_params={"kind": "hinge", "a": 1.0, "b": 2},
        churn="markov",
        churn_params={
            "p_fail": 0.15, "p_recover": 0.5, "min_up": 2,
            "p_slow": 0.2, "slow_factor": 2.0,
        },
        fl=FLWorkload(
            dataset="mnist", rounds=8, local_steps=2, batch_size=32,
            num_samples=1024, archive_depth=10,
        ),
    )),
)

# -- churn combinations: trace-driven fleet dynamics --------------------------

CHURN_COMBINATIONS = (
    # Memoryless flapping on a small-world gossip graph: one machine
    # begins the trace absent (a mid-trace *join*), two links flap with a
    # 4x outage penalty.
    register(Scenario(
        name="smallworld_churn_markov",
        topology="small_world",
        num_tasks=16,
        num_machines=6,
        machine_profile="lognormal",
        delay_model="distance",
        schedulers=("sdp",),
        rounds=24,
        topology_params={"k": 4, "rewire_prob": 0.2},
        churn="markov",
        churn_params={
            "p_fail": 0.08, "p_recover": 0.35,
            "start_down_fraction": 0.2, "min_up": 3,
            "link_outages": 2, "outage_len": 4, "outage_factor": 4.0,
        },
    )),
    # Weibull up/down sessions on an edge/cloud torus: shape_down < 1
    # mixes quick blips with long absences, clustered delays make the
    # re-solve's machine choice matter.
    register(Scenario(
        name="torus_churn_weibull",
        topology="torus",
        num_tasks=16,
        num_machines=6,
        machine_profile="bimodal",
        delay_model="cluster",
        schedulers=("sdp",),
        rounds=24,
        topology_params={"rows": 4},
        machine_params={"fast": 4.0, "slow": 1.0, "fast_fraction": 0.34},
        delay_params={"clusters": 2, "intra": 0.1, "inter": 1.0},
        churn="weibull",
        churn_params={
            "shape_up": 1.5, "scale_up": 10.0,
            "shape_down": 0.8, "scale_down": 3.0,
            "start_down_fraction": 0.2, "min_up": 3,
            "link_outages": 2, "outage_len": 4, "outage_factor": 3.0,
        },
    )),
    # Degraded-mode drill: a zero wall-clock solve budget makes EVERY
    # elastic SDP attempt fail (warm and cold retry), so the policy runs
    # the whole trace on its heft fallback — the record pins that a
    # stalled solver costs regret but never wedges the trace.
    register(Scenario(
        name="er_churn_degraded",
        topology="erdos_renyi",
        num_tasks=14,
        num_machines=6,
        machine_profile="lognormal",
        delay_model="uniform",
        schedulers=("sdp",),
        rounds=20,
        topology_params={"edge_prob": 0.2},
        churn="markov",
        churn_params={
            "p_fail": 0.1, "p_recover": 0.4,
            "start_down_fraction": 0.2, "min_up": 2,
            "link_outages": 1, "outage_len": 5, "outage_factor": 4.0,
            "solve_timeout": 0.0,
        },
    )),
)
