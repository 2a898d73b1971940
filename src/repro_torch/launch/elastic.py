"""Elastic runtime: fleet churn and stragglers trigger SDP re-scheduling.

The paper's scheduler runs once; at production scale machines fail, slow
down, leave, and COME BACK, so we keep (G_task, G_compute) live:

  - ``on_failure(machine)`` removes the machine and re-solves; unless the
    failure is ``permanent``, the machine's speed is stashed so
    ``on_recovery(machine)`` can later restore it under its ORIGINAL
    label — fail → rejoin → fail sequences of one machine compose, and a
    fail → rejoin round trip restores the pre-failure fleet exactly;
  - ``on_arrival(machine, speed, delays_to)`` grows the fleet with a
    genuinely new machine (explicit speed and delay rows); called
    without stats for a stashed label it delegates to ``on_recovery``;
  - ``on_delay_update(C)`` / ``on_delay_updates([C...])`` refresh the
    delay matrix (network drift, link outages) and re-schedule when the
    candidate beats the incumbent by ``reschedule_threshold``;
  - ``observe_round(times)`` EMA-updates machine speeds from measured
    per-machine round times and re-schedules on the same threshold;
  - every SDP re-solve warm-starts from the previous solver iterate.
    Beyond the structure-keyed cache in ``core.scheduler`` (which cannot
    tell two fleets of the same SIZE apart), the scheduler keeps its own
    fleet-composition-keyed cache: when a churn trace returns to a
    previously-seen set of live machines, the solve resumes from that
    exact composition's iterate.  The cache is LRU-bounded
    (``warm_cache_max``) and evicts compositions that can no longer
    recur (a machine departed permanently) — across a long churn trace
    it would otherwise grow with every fleet change.

Degraded mode: each solve runs under an optional wall-clock budget
(``solve_timeout``) and iteration budget (``solver_max_iters``) with
retry-once-then-fallback semantics — a failed attempt (solver exception,
non-finite bottleneck, overrun budget, or — with ``require_converged`` —
an unconverged SDP) is retried once from a cold start, and a second
failure degrades to the combinatorial ``fallback`` method (e.g.
``"heft"``) instead of wedging the trace.  ``fallback_count`` and
``history`` record every activation.

This is the scheduling part of fault tolerance; state recovery (a
checkpoint around the failure) is not part of the port yet.

The port's counterpart of ``repro.launch.elastic`` on its own ``schedule``,
``schedule_batch`` and warm-start cache.  ``device`` (None = the CUDA card,
raise without one; ``"cpu"`` runs the plain versions) is where every solve
runs.  On the card:

  - the kernels are built (``repro_torch.kernels.build.library``) when the
    scheduler is made, so no ``nvcc`` run counts against ``solve_timeout``,
    and each attempt's wall time ends after ``torch.cuda.synchronize``;
  - the retry catches what ``repro`` catches plus ``torch.linalg.LinAlgError``
    (a failed Cholesky or ``eigh`` on the device) by name, and nothing
    else: any other ``RuntimeError`` (a kernel that does not build or
    launch) propagates out of the scheduler instead of degrading to the
    fallback, as does a kernel's ``KernelInputError`` (inputs it cannot
    take, such as a fleet of more than 32 machines for ``bottleneck_eval``);
  - the composition cache holds the device solver's state as it is, float32
    tensors on the card (``repro_torch.core.sdp``), never copied to the host.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.bqp import bottleneck_time
from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.core.scheduler import (
    METHODS,
    Schedule,
    clear_warm_start,
    get_warm_start,
    schedule,
    schedule_batch,
    seed_warm_start,
)
from repro_torch.core.sdp import SDPOptions
from repro_torch.device import resolve_device
from repro_torch.kernels.build import KernelInputError

_SDP_FAMILY = ("sdp", "sdp_naive", "sdp_ls")

# What a failed attempt may raise and still be retried (then degraded):
# ``repro``'s types plus the port's linear-algebra failure, by name.  Not
# ``RuntimeError`` as a whole: a kernel's build or launch failure must
# propagate, and so must a kernel's refusal of its inputs
# (``KernelInputError``, a ``ValueError``; say a fleet past
# ``bottleneck_eval``'s 32 machines), which no retry or fallback may hide.
_RETRIED = (ValueError, ArithmeticError, np.linalg.LinAlgError, torch.linalg.LinAlgError)


@dataclasses.dataclass
class ElasticScheduler:
    task_graph: TaskGraph
    compute_graph: ComputeGraph
    method: str = "sdp"
    seed: int = 0
    reschedule_threshold: float = 0.10   # fractional bottleneck improvement
    ema_alpha: float = 0.3
    speed_clamp: float = 10.0            # max implied-speed ratio per round
    warm_start: bool = True              # reuse SDP iterates across re-solves
    # -- degraded mode ------------------------------------------------------
    # Method to degrade to when a solve fails twice (None: raise instead).
    fallback: str | None = None
    # Wall-clock budget per solve attempt; an overrun counts as a failure
    # (checked after the attempt — pair with solver_max_iters to bound the
    # attempt itself).
    solve_timeout: float | None = None
    # Iteration budget applied to every SDP solve (overrides the max_iters
    # of schedule_kwargs' sdp_options).
    solver_max_iters: int | None = None
    # Treat an unconverged SDP solve as a failure.
    require_converged: bool = False
    # -- composition warm-start cache ---------------------------------------
    warm_cache_max: int = 16
    # Extra kwargs forwarded to every ``schedule()`` call (num_samples,
    # sdp_options, ...) — the scenario engine sizes re-solves with these.
    schedule_kwargs: dict = dataclasses.field(default_factory=dict)
    # Where every solve runs: None = the CUDA card (raise without one).
    device: str | torch.device | None = None

    def __post_init__(self):
        self._dev = resolve_device(self.device)
        if self.fallback is not None:
            if self.fallback not in METHODS:
                raise ValueError(
                    f"unknown fallback method {self.fallback!r}; "
                    f"choose from {METHODS}"
                )
            if self.fallback == self.method:
                raise ValueError(
                    "fallback must differ from the primary method — "
                    "retrying the same solver is not a degraded mode"
                )
        if self._dev.type == "cuda" and self.method in _SDP_FAMILY:
            from repro_torch.kernels import build

            build.library()    # nvcc now, not inside the first timed solve
        self.machine_ids = list(range(self.compute_graph.num_machines))
        # Universe-label delay matrix: rows/cols of absent machines are kept
        # current through delay updates so recoveries rejoin under the
        # delays of the moment, not of their departure.
        self._C_full = self.compute_graph.C.copy()
        self._stash: dict[int, float] = {}        # failed label -> speed
        self._comp_states: dict[frozenset, dict] = {}   # LRU, insertion-ordered
        self.fallback_count = 0
        self.history: list[dict] = []
        self.current: Schedule = self._solve_guarded()
        self.history.insert(
            0, {"event": "init", "round": None,
                "bottleneck": self.current.bottleneck,
                "machines": len(self.machine_ids)}
        )

    # -- solving -------------------------------------------------------------
    def _schedule_kwargs(self) -> dict:
        kw = dict(self.schedule_kwargs)
        if self.solver_max_iters is not None and self.method in _SDP_FAMILY:
            opts = kw.get("sdp_options") or SDPOptions()
            kw["sdp_options"] = dataclasses.replace(
                opts, max_iters=int(self.solver_max_iters)
            )
        return kw

    def _schedule(self) -> Schedule:
        return schedule(
            self.task_graph, self.compute_graph, self.method, seed=self.seed,
            warm_start=self.warm_start, device=self._dev, **self._schedule_kwargs(),
        )

    def _remember_state(self, comp: frozenset) -> None:
        if not (self.warm_start and self.method in _SDP_FAMILY):
            return
        state = get_warm_start(self.task_graph, self.compute_graph)
        if state is None:
            return
        self._comp_states.pop(comp, None)
        self._comp_states[comp] = state                 # LRU: newest at end
        while len(self._comp_states) > self.warm_cache_max:
            self._comp_states.pop(next(iter(self._comp_states)))

    def _evict_unreachable(self) -> None:
        """Drop cached compositions that can no longer recur: a composition
        is reachable iff every machine in it is live or recoverable, so a
        permanent departure invalidates every composition containing it."""
        universe = set(self.machine_ids) | set(self._stash)
        for comp in [c for c in self._comp_states if not c <= universe]:
            del self._comp_states[comp]

    def _solve_guarded(self, round: int | None = None) -> Schedule:
        """One schedule consult under the degraded-mode contract.

        Attempt 1 warm-starts (restoring this exact fleet composition's
        cached iterate when one exists); on failure, attempt 2 retries
        once from a cold start (a poisoned warm state is a common cause);
        a second failure activates ``fallback`` — or raises when no
        fallback is configured.  Failure = solver exception, non-finite
        bottleneck, ``solve_timeout`` overrun, or (``require_converged``)
        an unconverged SDP.
        """
        comp = frozenset(self.machine_ids)
        reason = "unknown"
        for attempt in (0, 1):
            if attempt == 0 and self.warm_start:
                state = self._comp_states.get(comp)
                if state is not None:
                    seed_warm_start(self.task_graph, self.compute_graph, state)
            else:
                clear_warm_start(self.task_graph, self.compute_graph)
            t0 = time.perf_counter()
            try:
                s = self._schedule()
            except KernelInputError:
                raise
            except _RETRIED as exc:
                reason = f"raise:{type(exc).__name__}"
                continue
            if self._dev.type == "cuda":
                torch.cuda.synchronize(self._dev)
            elapsed = time.perf_counter() - t0
            if not np.isfinite(s.bottleneck):
                reason = "non-finite bottleneck"
                continue
            if self.solve_timeout is not None and elapsed > self.solve_timeout:
                reason = f"timeout:{elapsed:.3f}s>{self.solve_timeout:.3f}s"
                continue
            if (
                self.require_converged
                and self.method in _SDP_FAMILY
                and not s.info.get("sdp_converged", True)
            ):
                reason = "unconverged"
                continue
            self._remember_state(comp)
            return s
        if self.fallback is None:
            raise RuntimeError(
                f"scheduler {self.method!r} failed twice ({reason}) and no "
                f"fallback method is configured"
            )
        self.fallback_count += 1
        s = schedule(
            self.task_graph, self.compute_graph, self.fallback, seed=self.seed,
            device=self._dev,
        )
        self.history.append(
            {"event": f"fallback:{self.fallback}", "round": round,
             "reason": reason, "bottleneck": s.bottleneck,
             "machines": len(self.machine_ids)}
        )
        return s

    # -- failures ------------------------------------------------------------
    def on_failure(
        self, machine_id: int, *, permanent: bool = False,
        round: int | None = None,
    ) -> Schedule:
        """Remove a machine and re-solve.

        Non-permanent failures stash the machine's current speed so
        ``on_recovery`` can restore it later; ``permanent=True`` drops the
        stash and evicts every cached warm-start composition containing
        the label (those fleets can no longer recur).  Failing a machine
        that is not in the live fleet raises — a silently-absorbed double
        failure would desynchronize the fleet from the caller's view.
        """
        if machine_id not in self.machine_ids:
            raise ValueError(
                f"machine {machine_id} is not in the live fleet "
                f"{self.machine_ids} — double failure, or a label from "
                f"another fleet?"
            )
        if len(self.machine_ids) == 1:
            raise ValueError("failing the last machine would empty the fleet")
        local = self.machine_ids.index(machine_id)
        keep = [j for j in range(len(self.machine_ids)) if j != local]
        cg = self.compute_graph
        if permanent:
            self._stash.pop(machine_id, None)
        else:
            self._stash[machine_id] = float(cg.e[local])
        self.compute_graph = ComputeGraph(
            e=cg.e[keep], C=cg.C[np.ix_(keep, keep)]
        )
        self.machine_ids.pop(local)
        if permanent:
            self._evict_unreachable()
        self.current = self._solve_guarded(round)
        self.history.append(
            {
                "event": f"fail:{machine_id}",
                "round": round,
                "bottleneck": self.current.bottleneck,
                "machines": len(self.machine_ids),
            }
        )
        return self.current

    # -- arrivals and recoveries ---------------------------------------------
    def _admit(self, machine_id: int, speed: float, event: str,
               round: int | None) -> Schedule:
        """Insert a universe label into the live fleet and re-solve.

        Delay rows come from ``_C_full`` — the CURRENT network state, so a
        recovery during delay drift rejoins under the drifted delays.
        """
        pos = bisect.bisect_left(self.machine_ids, machine_id)
        self.machine_ids.insert(pos, machine_id)
        e_new = np.insert(self.compute_graph.e, pos, speed)
        C_new = self._C_full[np.ix_(self.machine_ids, self.machine_ids)]
        self.compute_graph = ComputeGraph(e=e_new, C=C_new)
        self.current = self._solve_guarded(round)
        self.history.append(
            {
                "event": f"{event}:{machine_id}",
                "round": round,
                "bottleneck": self.current.bottleneck,
                "machines": len(self.machine_ids),
            }
        )
        return self.current

    def on_recovery(
        self, machine_id: int, *, round: int | None = None
    ) -> Schedule:
        """Re-admit a failed machine under its ORIGINAL label.

        The speed is the one stashed at failure time; the delay rows are
        taken from the current universe delay matrix (which delay updates
        keep fresh while the machine is away).  With no intervening drift
        a fail → recover round trip restores the pre-failure compute
        graph exactly.
        """
        if machine_id in self.machine_ids:
            raise ValueError(
                f"machine {machine_id} is already in the live fleet"
            )
        if machine_id not in self._stash:
            raise ValueError(
                f"machine {machine_id} has no stashed state (never failed, "
                f"or failed permanently) — use on_arrival with explicit "
                f"speed and delays"
            )
        speed = self._stash.pop(machine_id)
        return self._admit(machine_id, speed, "recover", round)

    def on_arrival(
        self,
        machine_id: int,
        speed: float | None = None,
        delays_to: np.ndarray | None = None,
        delays_from: np.ndarray | None = None,
        *,
        round: int | None = None,
    ) -> Schedule:
        """Grow the fleet with an arriving machine and re-solve.

        For a label with stashed state and no explicit ``speed`` this is
        ``on_recovery``.  Otherwise the machine is new: ``speed`` (> 0)
        and ``delays_to`` (its delay TO every existing universe machine,
        indexed by original label) are required; ``delays_from`` (the
        reverse direction) defaults to ``delays_to`` (symmetric link).
        New labels must extend the universe densely (``machine_id`` ==
        current universe size) or re-use a departed label.
        """
        if machine_id in self.machine_ids:
            raise ValueError(
                f"machine {machine_id} is already in the live fleet"
            )
        if speed is None:
            if machine_id in self._stash:
                return self.on_recovery(machine_id, round=round)
            raise ValueError(
                f"machine {machine_id} has no stashed state — arriving "
                f"machines need explicit speed and delays_to"
            )
        if speed <= 0:
            raise ValueError("arriving machine speed must be > 0")
        if delays_to is None:
            raise ValueError("arriving machines need delays_to")
        U = self._C_full.shape[0]
        if machine_id > U:
            raise ValueError(
                f"machine labels must be dense: universe has {U} labels, "
                f"got {machine_id}"
            )
        d_to = np.asarray(delays_to, dtype=np.float64)
        d_from = (
            d_to if delays_from is None
            else np.asarray(delays_from, dtype=np.float64)
        )
        width = U if machine_id == U else U - 1
        for name, d in (("delays_to", d_to), ("delays_from", d_from)):
            if d.shape != (width,):
                raise ValueError(
                    f"{name} must have one entry per other universe machine "
                    f"({width},), got {d.shape}"
                )
            if np.any(d < 0):
                raise ValueError(f"{name} must be non-negative")
        if machine_id == U:
            grown = np.zeros((U + 1, U + 1))
            grown[:U, :U] = self._C_full
            grown[U, :U] = d_to
            grown[:U, U] = d_from
            self._C_full = grown
        else:
            others = [j for j in range(U) if j != machine_id]
            self._C_full[machine_id, others] = d_to
            self._C_full[others, machine_id] = d_from
            self._C_full[machine_id, machine_id] = 0.0
            self._stash.pop(machine_id, None)   # explicit stats supersede
        return self._admit(machine_id, float(speed), "join", round)

    # -- delay drift ---------------------------------------------------------
    def _ingest_delays(self, C_new: np.ndarray) -> np.ndarray:
        """Fold a delay update into the universe matrix; return the live C.

        Accepts the full universe matrix (original labels) or the live
        fleet's subset (sorted label order) — the subset case keeps
        absent machines' rows at their last known values.
        """
        C_new = np.asarray(C_new, dtype=np.float64)
        k = len(self.machine_ids)
        if C_new.shape == self._C_full.shape:
            self._C_full = C_new.copy()
            return C_new[np.ix_(self.machine_ids, self.machine_ids)]
        if C_new.shape == (k, k):
            self._C_full[np.ix_(self.machine_ids, self.machine_ids)] = C_new
            return C_new
        raise ValueError(
            f"delay matrix shape {C_new.shape} matches neither the universe "
            f"{self._C_full.shape} nor the live fleet ({k},{k})"
        )

    def on_delay_update(
        self, C_new: np.ndarray, *, round: int | None = None
    ) -> Schedule | None:
        """Refresh the delay matrix (network drift) and maybe re-schedule.

        The scenario engine's ``drift`` delay model calls this every
        ``reschedule_every`` rounds with the current ``DelayDrift.at(r)``;
        the churn path calls it with the engine's live effective delays
        after link-outage transitions.  ``C_new`` may be indexed by the
        ORIGINAL machine labels (subset to the live fleet here, so drift
        and failure events compose) or already subset.  Without fleet
        changes the warm-start fingerprint still hits and the SDP re-solve
        resumes from the previous iterate.  The new schedule is adopted
        only when it beats the current assignment's bottleneck *under the
        new delays* by ``reschedule_threshold`` (migration is not free).
        """
        cg = self.compute_graph
        self.compute_graph = ComputeGraph(e=cg.e, C=self._ingest_delays(C_new))
        current_t = bottleneck_time(
            self.task_graph, self.compute_graph, self.current.assignment
        )
        candidate = self._solve_guarded(round)
        if candidate.bottleneck < current_t * (1 - self.reschedule_threshold):
            self.current = candidate
            self.history.append(
                {"event": "migrate", "round": round,
                 "bottleneck": candidate.bottleneck}
            )
            return candidate
        self.history.append(
            {"event": "keep", "round": round, "bottleneck": current_t}
        )
        return None

    def on_delay_updates(
        self, C_list, *, round: int | None = None
    ) -> Schedule | None:
        """Batched drift re-solve across accumulated delay updates.

        When delay telemetry arrives faster than the re-schedule cadence,
        the backlog of matrices is solved as ONE batched SDP dispatch
        (``schedule_batch``): every lane shares the task graph and machine
        speeds and differs only in C, so the stacked solve amortizes
        per-dispatch overhead and the batched warm-start cache restores
        every lane from the previous consult's iterates at once.  The LAST
        matrix is adopted as the current network state; each lane's
        candidate assignment is re-evaluated under it and the best one is
        adopted iff it beats the current assignment's bottleneck by
        ``reschedule_threshold`` — an assignment tuned for an intermediate
        delay snapshot can still win under the latest one.  (The batched
        path has no degraded mode; single-consult churn re-solves go
        through ``on_delay_update``.)
        """
        C_list = list(C_list)
        if not C_list:
            return None
        if len(C_list) == 1:
            return self.on_delay_update(C_list[0], round=round)
        cg = self.compute_graph
        k = len(self.machine_ids)
        mats = []
        for C_new in C_list[:-1]:
            C_new = np.asarray(C_new, dtype=np.float64)
            if C_new.shape != (k, k):
                C_new = C_new[np.ix_(self.machine_ids, self.machine_ids)]
            mats.append(C_new)
        mats.append(self._ingest_delays(C_list[-1]))
        self.compute_graph = ComputeGraph(e=cg.e, C=mats[-1])
        candidates = schedule_batch(
            [self.task_graph] * len(mats),
            [ComputeGraph(e=cg.e, C=C) for C in mats],
            self.method,
            seed=self.seed,
            warm_start=self.warm_start,
            device=self._dev,
            **self.schedule_kwargs,
        )
        current_t = bottleneck_time(
            self.task_graph, self.compute_graph, self.current.assignment
        )
        times = [
            bottleneck_time(self.task_graph, self.compute_graph, c.assignment)
            for c in candidates
        ]
        best = int(np.argmin(times))
        if times[best] < current_t * (1 - self.reschedule_threshold):
            self.current = dataclasses.replace(
                candidates[best], bottleneck=float(times[best])
            )
            self.history.append(
                {"event": "migrate", "round": round,
                 "bottleneck": self.current.bottleneck}
            )
            return self.current
        self.history.append(
            {"event": "keep", "round": round, "bottleneck": current_t}
        )
        return None

    # -- stragglers ----------------------------------------------------------
    def observe_round(
        self,
        per_machine_time: np.ndarray,
        *,
        round: int | None = None,
        work_fraction: np.ndarray | None = None,
    ) -> Schedule | None:
        """Update speed estimates from measured times; maybe re-schedule.

        ``per_machine_time[j]`` is the measured busy time of machine j this
        round (e.g. a ``repro_torch.sim`` ``SimResult.busy`` row subset to the
        live fleet); implied speed = assigned work / time, clamped to
        within ``speed_clamp``× of the current estimate — a loaded machine
        reporting a time of ~0 would otherwise imply a near-infinite speed
        and poison the EMA with one spike no later round can wash out.

        ``work_fraction[j]`` (optional, default 1) is the fraction of its
        assigned work machine j actually completed this round — the
        completeness dimension of ``repro_torch.scenarios.profiles.churn_trace``.  A
        partial-work round finishes early NOT because the machine is fast,
        so implied speed uses the completed work ``loads · work_fraction``;
        without it the shortened busy time reads as a speedup and poisons
        the EMA.
        """
        cg = self.compute_graph
        per_machine_time = np.asarray(per_machine_time, dtype=np.float64)
        loads = np.zeros(cg.num_machines)
        np.add.at(loads, self.current.assignment, self.task_graph.p)
        if work_fraction is not None:
            work_fraction = np.asarray(work_fraction, dtype=np.float64)
            if work_fraction.shape != loads.shape:
                raise ValueError(
                    f"work_fraction shape {work_fraction.shape} != "
                    f"{loads.shape} (one completed-work fraction per live "
                    f"machine)"
                )
            if np.any(work_fraction <= 0) or np.any(work_fraction > 1):
                raise ValueError("work_fraction entries must be in (0, 1]")
            loads = loads * work_fraction
        implied = np.where(
            per_machine_time > 0, loads / np.maximum(per_machine_time, 1e-12), cg.e
        )
        implied = np.where(loads > 0, implied, cg.e)   # idle machines: keep
        implied = np.clip(
            implied, cg.e / self.speed_clamp, cg.e * self.speed_clamp
        )
        new_e = (1 - self.ema_alpha) * cg.e + self.ema_alpha * implied
        self.compute_graph = ComputeGraph(e=new_e, C=cg.C)

        current_t = bottleneck_time(
            self.task_graph, self.compute_graph, self.current.assignment
        )
        candidate = self._solve_guarded(round)
        if candidate.bottleneck < current_t * (1 - self.reschedule_threshold):
            self.current = candidate
            self.history.append(
                {"event": "migrate", "round": round,
                 "bottleneck": candidate.bottleneck}
            )
            return candidate
        self.history.append(
            {"event": "keep", "round": round, "bottleneck": current_t}
        )
        return None
