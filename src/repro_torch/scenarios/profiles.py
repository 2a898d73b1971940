"""Machine-heterogeneity profiles and delay models (scenario axes).

A numpy copy of ``repro.scenarios.profiles``: every generator draws from the
same ``np.random.Generator`` calls in the same order, so the same seed gives
bit-equal speeds, delays, drift phases and churn traces; ``control_events``
emits the port's own ``repro_torch.sim.ControlEvent``.

A scenario composes a task-graph family with a *machine profile* (the
speed vector ``e``) and a *delay model* (the pairwise delay matrix ``C``).
Both are pure functions of an ``np.random.Generator`` so scenario records
are reproducible from ``(scenario, seed)`` alone; the time-varying
``drift`` model wraps a static base model in a :class:`DelayDrift` whose
``at(round)`` yields the per-round matrix.

Profiles (``machine_speeds``):
  - ``uniform``   — homogeneous machines (``speed``, default 1).
  - ``bimodal``   — edge/cloud split: ``ceil(fast_fraction · N_K)`` cloud
    machines at ``fast`` speed, the rest edge devices at ``slow``.
  - ``lognormal`` — ``e ~ LogNormal(mu, sigma)``: a long-tailed fleet.
  - ``paper``     — the §4.1.2 setting ``e ~ |N(0, √15)|``.

Delay models (``delay_matrix``):
  - ``uniform``  — ``C ~ Unif(0, c_max)`` i.i.d. (the §4.2 FL setting).
  - ``distance`` — machines at uniform points of the unit square,
    ``C = base + scale · euclidean distance`` (symmetric).
  - ``cluster``  — machines split into ``clusters`` groups; intra-cluster
    links cost ``intra``, inter-cluster links ``inter``, with a symmetric
    multiplicative jitter (datacenter racks / geo regions).
  - ``paper``    — the §4.1.2 setting ``C ~ |N(0, √10)|``.
  - ``drift``    — time-varying: a static ``base`` model modulated per
    round (see :class:`DelayDrift`); the engine re-schedules mid-run via
    ``ElasticScheduler.on_delay_update``.

Churn traces (``churn_trace``): seeded per-machine up↔down state machines
plus intermittent-link outage windows, emitted as a round-indexed
:class:`ChurnTrace` the scenario engine turns into ``ControlEvent``
streams.  Models:

  - ``markov``  — geometric dwell times: each round an up machine fails
    with probability ``p_fail`` and a down machine returns with
    probability ``p_recover`` (memoryless flapping).
  - ``weibull`` — alternating up/down dwell durations drawn from Weibull
    distributions (``shape_up``/``scale_up``, ``shape_down``/
    ``scale_down``); ``shape > 1`` concentrates session lengths,
    ``shape < 1`` gives the heavy-tailed mix of long-lived and flappy
    machines seen in real device fleets.

Both models share ``start_down_fraction`` (machines that begin the trace
absent and later *join*), a ``min_up`` floor (a fail that would drop the
live fleet below it is postponed — the trace never strands the engine
without machines), and intermittent links: ``link_outages`` windows, each
multiplying one pair's delay by ``outage_factor`` for a sampled number of
rounds (non-overlapping per pair).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MACHINE_PROFILES = ("uniform", "bimodal", "lognormal", "paper")
DELAY_MODELS = ("uniform", "distance", "cluster", "paper", "drift")
CHURN_MODELS = ("markov", "weibull")

_CHURN_COMMON = {
    "start_down_fraction": 0.0,
    "min_up": 1,
    "link_outages": 0,
    "outage_len": 6,
    "outage_factor": 4.0,
    # FLGo-style device-state dimensions on top of up/down availability:
    # responsiveness (a slow-responder round multiplies the machine's
    # busy time by ``slow_factor``) and completeness (a partial-work
    # round completes only a ``[partial_floor, 1)`` fraction of the
    # round's work — busy time shrinks proportionally, and the elastic
    # speed estimator must be told or the shortened round poisons its
    # EMA — ``ElasticScheduler.observe_round(work_fraction=...)``).
    "p_slow": 0.0,
    "slow_factor": 3.0,
    "p_partial": 0.0,
    "partial_floor": 0.5,
}
CHURN_TRACE_PARAMS = {
    "markov": {"p_fail": 0.05, "p_recover": 0.25, **_CHURN_COMMON},
    "weibull": {
        "shape_up": 1.5, "scale_up": 24.0,
        "shape_down": 1.0, "scale_down": 6.0,
        **_CHURN_COMMON,
    },
}


def _take(kind: str, params: dict, defaults: dict) -> dict:
    """Resolve ``params`` against ``defaults``, rejecting unknown keys —
    a misspelled parameter must fail loudly, not silently fall back to the
    default while the sweep record's axes claim it was applied."""
    unknown = set(params) - set(defaults)
    if unknown:
        raise ValueError(
            f"unknown {kind} parameter(s) {sorted(unknown)}; "
            f"accepted: {sorted(defaults)}"
        )
    return {k: params.get(k, v) for k, v in defaults.items()}


def machine_speeds(
    profile: str, rng: np.random.Generator, num_machines: int, **params
) -> np.ndarray:
    """Speed vector ``e`` (num_machines,) for a named heterogeneity profile."""
    if profile == "uniform":
        p = _take(profile, params, {"speed": 1.0})
        return np.full(num_machines, float(p["speed"]))
    if profile == "bimodal":
        p = _take(profile, params,
                  {"fast": 4.0, "slow": 1.0, "fast_fraction": 0.25})
        n_fast = max(1, int(np.ceil(float(p["fast_fraction"]) * num_machines)))
        e = np.full(num_machines, float(p["slow"]))
        e[rng.choice(num_machines, size=n_fast, replace=False)] = float(p["fast"])
        return e
    if profile == "lognormal":
        p = _take(profile, params, {"mu": 0.0, "sigma": 0.75})
        return rng.lognormal(float(p["mu"]), float(p["sigma"]), size=num_machines)
    if profile == "paper":
        p = _take(profile, params, {"e_sigma": np.sqrt(15.0)})
        return np.abs(rng.normal(0.0, float(p["e_sigma"]), size=num_machines)) + 1e-2
    raise ValueError(
        f"unknown machine profile {profile!r}; choose from {MACHINE_PROFILES}"
    )


def delay_matrix(
    model: str, rng: np.random.Generator, num_machines: int, **params
) -> np.ndarray:
    """Delay matrix ``C`` (num_machines, num_machines), zero diagonal."""
    m = num_machines
    if model == "uniform":
        p = _take(model, params, {"c_max": 1.0})
        C = rng.uniform(0.0, float(p["c_max"]), size=(m, m))
    elif model == "distance":
        p = _take(model, params, {"base": 0.05, "scale": 1.0})
        pos = rng.uniform(0.0, 1.0, size=(m, 2))
        dist = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        C = float(p["base"]) + float(p["scale"]) * dist
    elif model == "cluster":
        p = _take(model, params,
                  {"clusters": 2, "intra": 0.1, "inter": 1.0, "jitter": 0.1})
        jitter = float(p["jitter"])
        label = rng.integers(0, int(p["clusters"]), size=m)
        same = label[:, None] == label[None, :]
        C = np.where(same, float(p["intra"]), float(p["inter"])).astype(np.float64)
        if jitter > 0:
            noise = rng.uniform(-jitter, jitter, size=(m, m))
            noise = 0.5 * (noise + noise.T)          # keep C symmetric
            C = C * (1.0 + noise)
    elif model == "paper":
        p = _take(model, params, {"c_sigma": np.sqrt(10.0)})
        C = np.abs(rng.normal(0.0, float(p["c_sigma"]), size=(m, m)))
    else:
        raise ValueError(
            f"unknown delay model {model!r}; choose from {DELAY_MODELS}"
        )
    np.fill_diagonal(C, 0.0)
    return C


@dataclasses.dataclass(frozen=True)
class DelayDrift:
    """Time-varying delay: sinusoidal per-link modulation of a base matrix.

    ``at(r) = base · (1 + amplitude · sin(2π r / period + phase))`` with an
    i.i.d. per-link phase (symmetrized so symmetric bases stay symmetric),
    clipped at zero, zero diagonal.  ``at(0) != base`` in general — the
    engine schedules against ``at(0)`` so round 0 is consistent.
    """

    base: np.ndarray
    amplitude: float
    period: float
    phase: np.ndarray

    def at(self, round_idx: int) -> np.ndarray:
        mod = 1.0 + self.amplitude * np.sin(
            2.0 * np.pi * round_idx / self.period + self.phase
        )
        C = np.clip(self.base * mod, 0.0, None)
        np.fill_diagonal(C, 0.0)
        return C


def drifting_delays(
    rng: np.random.Generator, num_machines: int, **params
) -> DelayDrift:
    """Build the ``drift`` delay model: base model + per-link modulation."""
    base_model = str(params.get("base", "distance"))
    if base_model == "drift":
        raise ValueError("drift cannot be its own base model")
    base_params = {k: v for k, v in params.items()
                   if k not in ("base", "amplitude", "period")}
    base = delay_matrix(base_model, rng, num_machines, **base_params)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=(num_machines, num_machines))
    phase = 0.5 * (phase + phase.T)
    return DelayDrift(
        base=base,
        amplitude=float(params.get("amplitude", 0.5)),
        period=float(params.get("period", 16.0)),
        phase=phase,
    )


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """A round-indexed fleet-dynamics trace.

    Attributes:
      num_rounds / num_machines: trace dimensions (original labels).
      machine_events: tuple of ``(round, kind, machine)`` with kind in
        {``fail``, ``join``, ``recover``} — ``join`` is the FIRST arrival
        of a machine that began the trace down, ``recover`` a return
        after a mid-trace failure (the engine treats them identically;
        the distinction is for trace analytics).  Within a round,
        arrivals precede failures so the ``min_up`` floor composes.
      link_events: tuple of ``(round, kind, machine, peer, factor)`` with
        kind in {``link_down``, ``link_up``} — outage windows whose
        ``link_up`` end falls inside the trace are closed explicitly.
      up_at: (R, K) bool — liveness of each machine during round r,
        AFTER that round's events (what the engine's fleet looks like).
      slow_at: (R, K) float or None — responsiveness state: the
        multiplicative busy-time factor of machine k in round r
        (``slow_factor`` in slow-responder rounds, 1 otherwise).  None
        when the trace was generated without the dimension
        (``p_slow = p_partial = 0``), keeping legacy traces bit-identical.
      work_at: (R, K) float or None — completeness state: the fraction of
        round r's work machine k actually performs (< 1 in partial-work
        rounds).  Busy time scales by the same fraction; feed it to
        ``ElasticScheduler.observe_round(work_fraction=...)`` so the
        shortened round is not mistaken for a speedup.
    """

    num_rounds: int
    num_machines: int
    machine_events: tuple
    link_events: tuple
    up_at: np.ndarray
    slow_at: np.ndarray | None = None
    work_at: np.ndarray | None = None

    def busy_factors(self) -> np.ndarray | None:
        """The (R, K) multiplicative busy-time matrix the event engine
        applies (``simulate(busy_factors=...)``): slow-responder factor ×
        completed-work fraction.  None when neither dimension is active."""
        if self.slow_at is None and self.work_at is None:
            return None
        out = np.ones((self.num_rounds, self.num_machines))
        if self.slow_at is not None:
            out = out * self.slow_at
        if self.work_at is not None:
            out = out * self.work_at
        return out

    @property
    def counts(self) -> dict:
        """Event tallies: fails / joins / recovers / link_downs."""
        c = {"fail": 0, "join": 0, "recover": 0}
        for _, kind, _ in self.machine_events:
            c[kind] += 1
        c["link_down"] = sum(
            1 for _, kind, *_ in self.link_events if kind == "link_down"
        )
        return c

    def control_events(self) -> list:
        """Materialize the trace as ``sim.ControlEvent`` objects, sorted by
        round with arrivals before failures before link transitions."""
        from repro_torch.sim.events import ControlEvent

        order = {"join": 0, "recover": 0, "fail": 1, "link_down": 2, "link_up": 2}
        merged = sorted(
            [(r, kind, m, -1, 1.0) for (r, kind, m) in self.machine_events]
            + list(self.link_events),
            key=lambda ev: (ev[0], order[ev[1]]),
        )
        return [
            ControlEvent(round=r, kind=kind, machine=m, peer=peer, factor=factor)
            for (r, kind, m, peer, factor) in merged
        ]


def _dwell(rng: np.random.Generator, shape: float, scale: float) -> int:
    """One Weibull dwell duration, in whole rounds (>= 1)."""
    return max(1, int(round(rng.weibull(shape) * scale)))


def churn_trace(
    rng: np.random.Generator,
    num_machines: int,
    num_rounds: int,
    model: str = "markov",
    **params,
) -> ChurnTrace:
    """Generate a seeded churn trace (see module docstring for models).

    The trace is a pure function of ``(rng state, arguments)``.  Machines
    that begin the trace down are emitted as ``fail`` events at round 0 —
    the engine starts from the full universe, so round 0 is where the
    initial absence is applied.
    """
    if model not in CHURN_MODELS:
        raise ValueError(
            f"unknown churn model {model!r}; choose from {CHURN_MODELS}"
        )
    p = _take(model, params, CHURN_TRACE_PARAMS[model])
    min_up = int(p["min_up"])
    if not (1 <= min_up <= num_machines):
        raise ValueError(
            f"min_up must be in [1, {num_machines}], got {min_up}"
        )
    n_down0 = min(
        int(np.floor(float(p["start_down_fraction"]) * num_machines)),
        num_machines - min_up,
    )
    start_down = set(
        int(m)
        for m in rng.choice(num_machines, size=n_down0, replace=False)
    ) if n_down0 > 0 else set()

    up = np.array([m not in start_down for m in range(num_machines)])
    ever_up = up.copy()
    events = [(0, "fail", m) for m in sorted(start_down)]
    up_at = np.zeros((num_rounds, num_machines), dtype=bool)

    if model == "weibull":
        # Next transition round per machine: starting-up machines fail
        # after an up-dwell, starting-down machines arrive after a
        # down-dwell.
        next_t = np.array([
            _dwell(rng, float(p["shape_up"]), float(p["scale_up"]))
            if up[m] else
            _dwell(rng, float(p["shape_down"]), float(p["scale_down"]))
            for m in range(num_machines)
        ])

    for r in range(num_rounds):
        if r > 0:
            if model == "markov":
                arrive = [
                    m for m in range(num_machines)
                    if not up[m] and rng.random() < float(p["p_recover"])
                ]
                depart = [
                    m for m in range(num_machines)
                    if up[m] and rng.random() < float(p["p_fail"])
                ]
            else:
                arrive = [
                    m for m in range(num_machines)
                    if not up[m] and next_t[m] <= r
                ]
                depart = [
                    m for m in range(num_machines)
                    if up[m] and next_t[m] <= r
                ]
            for m in arrive:
                up[m] = True
                events.append((r, "join" if not ever_up[m] else "recover", m))
                ever_up[m] = True
                if model == "weibull":
                    next_t[m] = r + _dwell(
                        rng, float(p["shape_up"]), float(p["scale_up"])
                    )
            for m in depart:
                if int(np.sum(up)) <= min_up:
                    # Postpone: under weibull the pending transition fires
                    # at the next round with headroom; under markov the
                    # machine simply re-rolls next round.
                    continue
                up[m] = False
                events.append((r, "fail", m))
                if model == "weibull":
                    next_t[m] = r + _dwell(
                        rng, float(p["shape_down"]), float(p["scale_down"])
                    )
        up_at[r] = up

    link_events = []
    n_outages = int(p["link_outages"])
    if n_outages > 0 and num_machines >= 2 and num_rounds >= 2:
        factor = float(p["outage_factor"])
        if factor <= 1.0:
            raise ValueError("outage_factor must be > 1 (a delay penalty)")
        mean_len = max(1, int(p["outage_len"]))
        occupied: dict[tuple, list] = {}
        for _ in range(n_outages):
            for _try in range(20):
                i, j = rng.choice(num_machines, size=2, replace=False)
                pair = (min(int(i), int(j)), max(int(i), int(j)))
                r0 = int(rng.integers(0, num_rounds - 1))
                length = int(rng.integers(1, 2 * mean_len + 1))
                r1 = min(r0 + length, num_rounds)
                if all(
                    r1 <= a or r0 >= b for (a, b) in occupied.get(pair, [])
                ):
                    occupied.setdefault(pair, []).append((r0, r1))
                    link_events.append(
                        (r0, "link_down", pair[0], pair[1], factor)
                    )
                    if r1 < num_rounds:
                        link_events.append(
                            (r1, "link_up", pair[0], pair[1], 1.0)
                        )
                    break
    link_events.sort(key=lambda ev: ev[0])

    # Responsiveness/completeness states draw LAST, and only when active:
    # traces generated with the legacy parameter set consume exactly the
    # legacy rng stream and stay bit-identical.
    slow_at = work_at = None
    p_slow, p_partial = float(p["p_slow"]), float(p["p_partial"])
    if not (0.0 <= p_slow <= 1.0 and 0.0 <= p_partial <= 1.0):
        raise ValueError(
            f"p_slow/p_partial must be probabilities, got "
            f"{p_slow}/{p_partial}"
        )
    if p_slow > 0.0:
        slow_factor = float(p["slow_factor"])
        if slow_factor <= 1.0:
            raise ValueError(
                f"slow_factor must be > 1 (a busy-time penalty), got "
                f"{slow_factor}"
            )
        mask = rng.random((num_rounds, num_machines)) < p_slow
        slow_at = np.where(mask, slow_factor, 1.0)
    if p_partial > 0.0:
        floor = float(p["partial_floor"])
        if not 0.0 < floor < 1.0:
            raise ValueError(
                f"partial_floor must be in (0, 1), got {floor}"
            )
        mask = rng.random((num_rounds, num_machines)) < p_partial
        frac = rng.uniform(floor, 1.0, size=(num_rounds, num_machines))
        work_at = np.where(mask, frac, 1.0)

    return ChurnTrace(
        num_rounds=num_rounds,
        num_machines=num_machines,
        machine_events=tuple(events),
        link_events=tuple(link_events),
        up_at=up_at,
        slow_at=slow_at,
        work_at=work_at,
    )
