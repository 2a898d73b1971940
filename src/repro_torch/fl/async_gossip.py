"""Barrier-free gossip training on delivered snapshots (counterpart of
``repro.fl.async_gossip``).

:class:`AsyncGossipTrainer` couples the stacked gossip engine
(``repro_torch.fl.gossip``) to the event engine's barrier-free timing
(``repro_torch.sim``): each edge mixes the *latest delivered* snapshot of
its sender, the per-(round, edge) version the engine recorded in
``SimResult.mix_versions``, weighted by a staleness discount ``s(Δτ)``
(``repro_torch.fl.staleness``).  A round on the one block of all N_T users:

  - **local steps** for every row of the block at once, each user at its
    own data cursor: a user on a machine that is down does not advance, so
    cursors, epochs and data orders are kept per user on the host (they
    depend only on the ``active`` masks; each user reshuffles at its own
    epoch), and the round's ``(local_steps, N_T, batch)`` sample indices go
    to the device in one copy that does not wait for the device.  The down
    users' rows of the replica buffer, the momentum and the error-feedback
    residual are copied out before the round and back after it, so they
    stay bit-equal (zeroing their gradient would not: momentum still moves);
  - **compression** through the stacked engine's ``_Block.compress`` (one
    ``topk_mask`` / ``int8_roundtrip`` launch over every leaf);
  - **the message archive**: a ring of depth S laid out slot-major,
    ``(S, N_T, L)`` float32, so publishing version r is one contiguous
    ``(N_T, L)`` slab write into slot ``r mod S`` (active rows only); an
    ``(N_T, S)`` version table on the host, −1 where nothing was published,
    tells a delivered version from an evicted one;
  - **the staleness-weighted mix**: an ``(N_T, S·N_T)`` matrix M holds
    ``M[dst_e, slot_e·N_T + src_e] = w_e · s(r − v_e)`` for every valid edge
    into an active receiver, and 0 elsewhere (evicted versions, never
    delivered ones with v = −1, down receivers); one ``gossip_mix_all``
    launch over the archive seen as ``(S·N_T, L)`` sums every receiver's
    incoming mass in a fixed order (no atomics), and
    ``p ← (self_w + deficit) · p + incoming``, where ``deficit`` refunds the
    discounted and invalid mass to the receiver's self-weight so each mixing
    row still sums to one.

Degenerate anchor: all users active, every edge fresh (``v_e = r``) and
s ≡ 1 mix exactly this round's messages with exactly the stacked engine's
weights, so per-round losses reproduce the stacked engine's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.graphs import TaskGraph
from repro_torch.data.synthetic import ImageDataset
from repro_torch.fl.gossip import GossipConfig, GossipTrainer, mixing_arrays
from repro_torch.fl.staleness import StalenessWeights
from repro_torch.kernels.gossip_mix import gossip_mix_all


class AsyncGossipTrainer(GossipTrainer):
    """Stacked gossip trainer whose exchange runs on delivered versions.

    ``step_round(active=None, edge_versions=None)``
        One barrier-free round.  ``active`` is an ``(N_T,)`` bool mask of the
        users whose machine is up this round (default all); ``edge_versions``
        an ``(|E|,)`` int array of the snapshot version delivered on each
        task-graph edge, in ``task_graph.edges`` order: one row of
        ``SimResult.mix_versions`` (default: this round's own version).
        Returns the round record plus ``stale_mixes`` (edges mixed with
        Δτ > 0), ``invalid_edges`` (versions never delivered or evicted) and
        ``mix_lag_hist``, the round's per-edge staleness histogram (index Δτ,
        never-delivered edges excluded); ``lag_hist`` accrues it and
        ``total_stale_mixes`` the stale mixes.

    ``archive_depth``
        Ring depth S: snapshots older than S rounds are evicted.  The
        archive holds S·N_T·L float32 on the device.

    The other arguments are ``GossipTrainer``'s; the engine is always the
    stacked one.
    """

    def __init__(
        self,
        task_graph: TaskGraph,
        init_params: Callable[[torch.Generator], dict] | dict,
        shards: list[ImageDataset],
        cfg: GossipConfig | None = None,
        seed: int = 0,
        staleness: StalenessWeights | None = None,
        archive_depth: int = 8,
        *,
        device: str | torch.device | None = None,
        epoch_perms: np.ndarray | None = None,
    ):
        if archive_depth < 1:
            raise ValueError(f"archive_depth must be >= 1 (got {archive_depth})")
        self.staleness = staleness if staleness is not None else StalenessWeights()
        self.archive_depth = int(archive_depth)
        self.total_stale_mixes = 0
        # lag_hist[d] = mixes observed at staleness Δτ = d over all rounds
        self.lag_hist = np.zeros(1, dtype=np.int64)
        super().__init__(task_graph, init_params, shards, cfg, seed, backend="stacked",
                         device=device, epoch_perms=epoch_perms)
        self_w, self._src, self._dst, self._w_edge, _ = mixing_arrays(
            task_graph, self.cfg.aggregate_self_weight)
        self._self_w = self_w
        n, S, dev = self.n, self.archive_depth, self.device
        self.archive = torch.zeros((S, n, self.layout.size), device=dev)
        self._versions = np.full((n, S), -1, dtype=np.int64)
        self._M = torch.zeros((n, S * n), device=dev)
        self._row_self = torch.ones((n, 1), device=dev)
        self._cursors = np.zeros(n, dtype=np.int64)
        self._epochs = np.zeros(n, dtype=np.int64)
        self._perm = torch.arange(self._chunk).repeat(n, 1)   # each user's data order
        self._tables: dict[int, torch.Tensor] = {}  # epoch -> (N_T, chunk) data orders
        self._drawn = 0

    # -- per-user data cursors ----------------------------------------------
    def _table(self, epoch: int) -> torch.Tensor:
        """Every user's data order in epoch ≥ 1 (tables drawn in epoch order)."""
        while self._drawn < epoch:
            self._drawn += 1
            self._tables[self._drawn] = self._epoch_perm(self._drawn)
        return self._tables[epoch]

    def _round_indices(self, active: np.ndarray) -> torch.Tensor:
        """The (local_steps, N_T, batch) sample indices of this round's steps:
        active users advance (and reshuffle at their own epoch), down users
        read in place."""
        batch, chunk = self.cfg.batch_size, self._chunk
        cur, span = self._cursors, torch.arange(batch)
        steps = []
        for _ in range(self.cfg.local_steps):
            wrap = np.flatnonzero(active & (cur + batch > chunk))
            if wrap.size:
                self._epochs[wrap] += 1
                cur[wrap] = 0
                for e in np.unique(self._epochs[wrap]):
                    users = torch.from_numpy(wrap[self._epochs[wrap] == e])
                    self._perm[users] = self._table(int(e))[users]
                for e in [e for e in self._tables if e < self._epochs.min()]:
                    del self._tables[e]
            off = torch.from_numpy(np.where(active, cur, np.minimum(cur, chunk - batch)))
            steps.append(self._perm.gather(1, off[:, None] + span))
            cur[active] += batch
        return torch.stack(steps)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the trainer's device; to a card through pinned
        memory, so the copy waits for nothing queued before it."""
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- the staleness-weighted mixing matrix -------------------------------
    def _mix_weights(self, active: np.ndarray, versions: np.ndarray, r: int):
        """(M (N_T, S·N_T), row_self (N_T,), stale, invalid) on the host."""
        n, S = self.n, self.archive_depth
        src, dst, w_edge = self._src, self._dst, self._w_edge
        slot = np.maximum(versions, 0) % S
        valid = (versions >= 0) & (self._versions[src, slot] == versions)
        lag = r - versions
        s_w = self.staleness.torch_weights(torch.from_numpy(lag)).numpy()
        recv = active[dst]
        w_eff = np.where(valid & recv, w_edge * s_w, 0.0).astype(np.float32)
        M = np.zeros((n, S * n), np.float32)
        np.add.at(M, (dst, slot * n + src), w_eff)        # duplicate edges accumulate
        deficit = np.zeros(n, np.float32)
        np.add.at(deficit, dst, np.where(recv, w_edge - w_eff, 0.0).astype(np.float32))
        stale = int(np.sum(valid & (lag > 0) & recv))
        invalid = int(np.sum(~valid & recv))
        return M, self._self_w + deficit, stale, invalid

    # -- one round ----------------------------------------------------------
    def _check(self, active, edge_versions) -> tuple[np.ndarray, np.ndarray]:
        n_e = len(self._src)
        if active is None:
            active = np.ones(self.n, dtype=bool)
        else:
            active = np.asarray(active, dtype=bool)
            if active.shape != (self.n,):
                raise ValueError(f"active mask shape {active.shape} != ({self.n},)")
        if edge_versions is None:
            edge_versions = np.full(n_e, self.round, dtype=np.int64)
        else:
            edge_versions = np.asarray(edge_versions, dtype=np.int64)
            if edge_versions.shape != (n_e,):
                raise ValueError(
                    f"edge_versions shape {edge_versions.shape} != ({n_e},) "
                    f"— one delivered version per task-graph edge"
                )
            if np.any(edge_versions > self.round):
                raise ValueError(
                    f"edge_versions reference round {int(edge_versions.max())} > current "
                    f"round {self.round} — a snapshot cannot be delivered before it is "
                    f"published"
                )
        return active, edge_versions

    @torch.no_grad()
    def _publish_and_mix(self, msgs: torch.Tensor, active: np.ndarray,
                         versions: np.ndarray) -> tuple[int, int]:
        blk, r, S = self._blocks[0], self.round, self.archive_depth
        slot = r % S
        up = np.flatnonzero(active)
        if up.size == self.n:
            self.archive[slot].copy_(msgs)
        elif up.size:
            idx = self._to_device(torch.from_numpy(up))
            self.archive[slot].index_copy_(0, idx, msgs.index_select(0, idx))
        self._versions[up, slot] = r
        if not len(self._src):
            self._mark("archive")
            return 0, 0
        M, row_self, stale, invalid = self._mix_weights(active, versions, r)
        self._M.copy_(self._to_device(torch.from_numpy(M)))
        self._row_self.copy_(self._to_device(torch.from_numpy(row_self)[:, None]))
        self._mark("archive")
        gossip_mix_all(self.archive.view(S * self.n, -1), self._M, out=blk.incoming)
        blk.model.flat.mul_(self._row_self).add_(blk.incoming)
        return stale, invalid

    def step_round(self, active=None, edge_versions=None) -> dict:
        """One barrier-free gossip round on delivered snapshot versions."""
        active, edge_versions = self._check(active, edge_versions)
        # per-edge lag histogram; never-delivered edges (v = -1) are invalid, not lags
        delivered = edge_versions[edge_versions >= 0]
        lag_hist = np.bincount((self.round - delivered).astype(np.int64), minlength=1)
        if len(lag_hist) > len(self.lag_hist):
            self.lag_hist = np.pad(self.lag_hist, (0, len(lag_hist) - len(self.lag_hist)))
        self.lag_hist[: len(lag_hist)] += lag_hist

        blk = self._blocks[0]
        self._mark("start")
        down = np.flatnonzero(~active)
        if down.size:        # the down users' state, put back bit for bit after the round
            down_t = self._to_device(torch.from_numpy(down))
            state = [t for t in (blk.model.flat, blk.momentum, blk.residual) if t is not None]
            saved = [t.detach().index_select(0, down_t) for t in state]
        blk.mask = self._to_device(torch.from_numpy(active.astype(np.float32)))
        idx = self._to_device(self._round_indices(active))
        sums = [blk.local_step(self.opt, step, self.cfg.batch_size) for step in idx]
        self._mark("local")
        msgs = blk.compress(self.cfg.compressor, self.layout.columns())
        self._mark("compress")
        stale, invalid = self._publish_and_mix(msgs, active, edge_versions)
        if down.size:
            with torch.no_grad():
                for t, rows in zip(state, saved):
                    t.index_copy_(0, down_t, rows)
        self._mark("mix")
        self.round += 1
        self.total_stale_mixes += stale
        steps = max(int(active.sum()), 1) * self.cfg.local_steps
        return {
            "round": self.round,
            "mean_loss": float(torch.stack(sums).sum()) / steps,
            "stale_mixes": stale,
            "invalid_edges": invalid,
            "mix_lag_hist": lag_hist.tolist(),
            "dropped_samples": self.dropped_samples,
        }
