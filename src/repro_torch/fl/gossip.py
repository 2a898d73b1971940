"""Gossip-based federated learning (paper §2.1 / §4.2), the stacked engine
(counterpart of ``repro.fl.gossip`` with ``backend="stacked"``).

Users are the vertices of the task graph.  Each round every user trains on
its next data chunk, ships its parameters (or a compressed delta) to its
out-neighbours, and averages the models it received with its own.

All users' replicas live in one flat ``(N_T, L)`` float32 buffer
(``fl.cnn.StackedCNN``), and so do the momentum and the error-feedback
residual.  One round is:

  - ``local_steps`` of SGD with momentum for every user at once: one
    forward and one backward of the sum over users of each user's mean loss
    (so each user gets its own, unscaled gradient), then two in-place passes
    over the flat buffers;
  - with a compressor, per leaf of the CNN: the threshold or scale of each
    user's leaf (``torch.topk`` / a max), then one fused kernel that writes
    the message over the delta and the residual in place
    (``kernels.compress``);
  - the exchange as one product with the row-normalized mixing matrix W
    (``kernels.gossip_mix``), read straight from the flat buffer, and the
    self-weighted update ``p ← self_w · p + W · msgs``.

The host tracks the data cursor and epoch as Python ints (every user has
the same chunk and batch size), and reads one number per round: the mean
loss.  Epoch 0 walks each user's shard in order, as ``repro`` does; later
epochs draw a permutation per user from a CPU ``torch.Generator`` seeded
from ``seed`` (``repro`` draws them from JAX's PRNG, which the port cannot
reproduce), or take them from a caller-given ``(N_T, epochs, chunk)`` table,
as the parity tests do with ``repro``'s.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.convert import epoch_perms_from_arrays
from repro_torch.core.graphs import TaskGraph
from repro_torch.data.synthetic import ImageDataset, stack_shards
from repro_torch.device import resolve_device
from repro_torch.fl.cnn import StackedCNN
from repro_torch.kernels.compress import int8_roundtrip, topk_mask
from repro_torch.kernels.gossip_mix import gossip_mix_all
from repro_torch.train.compression import Int8, TopK, int8_scale, topk_count
from repro_torch.train.optim import SGDM

BACKENDS = ("auto", "stacked")
NOT_PORTED = {
    "reference": "the per-user reference engine is not ported yet "
                 "(ROADMAP.md Queue 1, 'Per-user and barrier-free FL')",
    "sharded": "the mesh-sharded engine is not ported yet "
               "(ROADMAP.md Queue 1, 'Mesh-sharded FL')",
}


@dataclasses.dataclass
class GossipConfig:
    local_steps: int = 4          # minibatch steps per round (one chunk)
    batch_size: int = 64
    lr: float = 0.05
    momentum: float = 0.9
    aggregate_self_weight: float = 0.5   # weight of own model in the average
    compressor: Any = None        # repro_torch.train.compression.TopK / Int8 / None
    backend: str = "auto"         # "stacked" or "auto" (= stacked)


def mixing_arrays(
    task_graph: TaskGraph, self_weight: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Row-normalized gossip mixing built from ``TaskGraph.edges``.

    Edge (i, j) means user i sends to user j.  Receiver j averages its own
    model with weight ``self_weight`` and its indeg(j) incoming messages
    with weight ``(1 - self_weight) / indeg(j)``; a user with no incoming
    edges keeps its model (self weight 1, empty row in W).

    Returns ``(self_w (N,), src (|E|,), dst (|E|,), w_edge (|E|,), W (N, N))``
    where ``W[j, i] = w_edge`` for each edge — the incoming-message part
    only: ``new_params = diag(self_w) · params + W · messages``.  Duplicate
    edges accumulate.  W is always built: the port's exchange is the W
    product.
    """
    n = task_graph.num_tasks
    indeg = np.zeros(n, dtype=np.int64)
    for (_, j) in task_graph.edges:
        indeg[j] += 1
    self_w = np.where(indeg > 0, self_weight, 1.0).astype(np.float32)
    src = np.asarray([i for (i, _) in task_graph.edges], dtype=np.int32)
    dst = np.asarray([j for (_, j) in task_graph.edges], dtype=np.int32)
    w_edge = (
        (1.0 - self_weight) / np.maximum(indeg[dst], 1)
    ).astype(np.float32) if len(task_graph.edges) else np.zeros(0, np.float32)
    W = np.zeros((n, n), dtype=np.float32)
    if len(task_graph.edges):
        # accumulate, not assign: TaskGraph does not dedupe edges
        np.add.at(W, (dst, src), w_edge)
    return self_w, src, dst, w_edge, W


class GossipTrainer:
    """Holds every user's replica on one device and runs gossip rounds.

    ``step_round() -> {"round", "mean_loss", "dropped_samples"}``;
    ``user_params(i)`` / ``params`` read replicas back as trees of numpy
    arrays in ``repro``'s layout.

    ``init_params`` is either a callable ``(torch.Generator) -> tree`` (for
    example ``fl.cnn.init_cnn_params`` with the data's shape), called once
    with a CPU generator seeded from ``seed``, or the tree itself; every
    user starts from it.  The model is the paper's CNN (``fl.cnn``): unlike
    ``repro``'s trainer this one takes no loss function, because its batched
    forward is written out for that model.  ``device=None`` means the CUDA
    card (``RuntimeError`` without one); ``device="cpu"`` runs the kernels'
    plain versions.  ``epoch_perms`` (``(N_T, E, chunk)``, epoch e ≥ 1 uses
    ``epoch_perms[:, e - 1]``) replaces the trainer's own reshuffles.

    ``stage_events``: set it to a list to have each CUDA round append
    ``(stage, torch.cuda.Event)`` after its local steps, its compression and
    its exchange (``chip_smoke.py`` times the stages with them).
    """

    def __init__(
        self,
        task_graph: TaskGraph,
        init_params: Callable[[torch.Generator], dict] | dict,
        shards: list[ImageDataset],
        cfg: GossipConfig | None = None,
        seed: int = 0,
        backend: str | None = None,
        *,
        device: str | torch.device | None = None,
        epoch_perms: np.ndarray | None = None,
    ):
        self.g = task_graph
        self.cfg = cfg or GossipConfig()
        self.n = task_graph.num_tasks
        if len(shards) != self.n:
            raise ValueError(f"{len(shards)} shards for {self.n} users")
        self.shards = shards
        self.backend = self._resolve_backend(backend or self.cfg.backend)
        self.device = resolve_device(device)
        comp = self.cfg.compressor
        if comp is not None and not isinstance(comp, (TopK, Int8)):
            raise ValueError(f"unsupported compressor {comp!r}: use TopK or Int8")

        xs, ys = stack_shards(shards)
        self._chunk = int(ys.shape[1])
        self.dropped_samples = int(sum(len(s.y) - self._chunk for s in shards))
        longest = max(len(s.y) for s in shards)
        if longest - self._chunk > 1:
            warnings.warn(
                f"uneven shards truncated to the minimum length {self._chunk} "
                f"(longest holds {longest}); pass equal-size shards to train "
                "on all samples",
                stacklevel=2,
            )
        if self._chunk < self.cfg.batch_size:
            raise ValueError(f"shard chunk {self._chunk} < batch_size {self.cfg.batch_size}")
        self._epoch_perms = (
            None if epoch_perms is None
            else epoch_perms_from_arrays(epoch_perms, self.n, self._chunk)
        )

        dev = self.device
        common = init_params(torch.Generator().manual_seed(seed)) if callable(init_params) \
            else init_params
        self.model = StackedCNN(common, self.n, dev)
        self.layout = self.model.layout
        flat = self.model.flat
        self.opt = SGDM(learning_rate=self.cfg.lr, momentum=self.cfg.momentum)
        self._momentum = torch.zeros_like(flat, requires_grad=False)
        self._residual = None if comp is None else torch.zeros_like(self._momentum)
        self._msgs = None if comp is None else torch.empty_like(self._momentum)
        self._incoming = torch.empty_like(self._momentum)

        self_w, _, _, _, W = mixing_arrays(task_graph, self.cfg.aggregate_self_weight)
        self._self_w = torch.from_numpy(self_w).to(dev)[:, None]
        self._W = torch.from_numpy(W).to(dev)

        self._xs = torch.from_numpy(xs).to(dev)
        self._ys = torch.from_numpy(ys).long().to(dev)
        self._rows = torch.arange(self.n, device=dev)[:, None]
        self._perm = torch.arange(self._chunk, device=dev).expand(self.n, -1)
        self._perm_gen = torch.Generator().manual_seed(seed * 1_000_003 + 0x0DA7A)
        self._cursor = 0
        self._epoch = 0
        self.round = 0
        self.stage_events: list | None = None

    @staticmethod
    def _resolve_backend(backend: str) -> str:
        if backend in NOT_PORTED:
            raise NotImplementedError(f"backend={backend!r}: {NOT_PORTED[backend]}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        return "stacked"

    # -- replica access -----------------------------------------------------
    def user_params(self, i: int) -> dict:
        """User i's parameters as a tree of numpy arrays (``repro``'s layout)."""
        return self.layout.unflatten(self.model.flat[i].detach().to("cpu", copy=True).numpy())

    @property
    def params(self) -> list:
        return [self.user_params(i) for i in range(self.n)]

    # -- one round ----------------------------------------------------------
    def _epoch_perm(self, epoch: int) -> torch.Tensor:
        if self._epoch_perms is None:
            keys = torch.rand((self.n, self._chunk), generator=self._perm_gen)
            perm = torch.argsort(keys, dim=1)
        else:
            if epoch > self._epoch_perms.shape[1]:
                raise ValueError(f"epoch {epoch} is past the {self._epoch_perms.shape[1]} "
                                 "epochs of the given permutation table")
            perm = torch.from_numpy(self._epoch_perms[:, epoch - 1])
        return perm.to(self.device)

    def _next_batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        batch = self.cfg.batch_size
        if self._cursor + batch > self._chunk:       # new epoch, reshuffle
            self._epoch += 1
            self._perm = self._epoch_perm(self._epoch)
            self._cursor = 0
        idx = self._perm[:, self._cursor:self._cursor + batch]
        self._cursor += batch
        return self._xs[self._rows, idx], self._ys[self._rows, idx]

    def _local_step(self) -> torch.Tensor:
        x, y = self._next_batch()
        flat = self.model.flat
        flat.grad = None
        losses = self.model.losses(x, y)
        losses.sum().backward()            # the sum: every user's own gradient
        self.opt.update_(flat, flat.grad, self._momentum)
        return losses.detach()

    @torch.no_grad()
    def _compress(self) -> torch.Tensor:
        """Messages of this round; updates the error-feedback residual."""
        comp = self.cfg.compressor
        flat = self.model.flat
        if comp is None:
            return flat.detach()
        msgs = torch.add(flat, self._residual, out=self._msgs)     # the delta
        for a, b in self.layout.columns():
            x, resid = msgs[:, a:b], self._residual[:, a:b]
            if isinstance(comp, TopK):
                k = topk_count(comp.fraction, b - a)
                thr = torch.topk(torch.abs(x), k, dim=1).values[:, -1].contiguous()
                topk_mask(x, thr, out=(x, resid))
            else:
                int8_roundtrip(x, int8_scale(x), out=(x, resid))
        return msgs

    def _mark(self, stage: str) -> None:
        if self.stage_events is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((stage, ev))

    def step_round(self) -> dict:
        """One gossip round: local training, compression, exchange, average."""
        self._mark("start")
        losses = [self._local_step() for _ in range(self.cfg.local_steps)]
        self._mark("local")
        msgs = self._compress()
        self._mark("compress")
        with torch.no_grad():
            gossip_mix_all(msgs, self._W, out=self._incoming)
            self.model.flat.mul_(self._self_w).add_(self._incoming)
        self._mark("mix")
        self.round += 1
        return {
            "round": self.round,
            "mean_loss": float(torch.stack(losses).mean()),
            "dropped_samples": self.dropped_samples,
        }
