"""Gossip-based federated learning (paper §2.1 / §4.2): the stacked, the
mesh-sharded and the per-user reference engines (counterpart of
``repro.fl.gossip``).

Users are the vertices of the task graph.  Each round every user trains on
its next data chunk, ships its parameters (or a compressed delta) to its
out-neighbours, and averages the models it received with its own.

The three engines hold the population in blocks of contiguous users, each
on one device (``_Block``): the users' replicas in one flat ``(rows, L)``
float32 buffer (``fl.cnn.StackedCNN``), and beside them the momentum, the
error-feedback residual and the users' data.  They share the round's first
two stages:

  - ``local_steps`` of SGD with momentum for every user of a block at once:
    one forward and one backward of the sum over users of each user's mean
    loss (so each user gets its own, unscaled gradient), then two in-place
    passes over the flat buffers;
  - with a compressor: the threshold or scale of each user's leaf of the
    CNN (``torch.topk`` / a max per leaf, gathered into one ``(rows,
    n_leaves)`` table), then one fused kernel over every leaf that writes
    the message over the delta and the residual in place
    (``kernels.compress``).  Without one, the messages are the parameters.

and differ in the exchange:

  - ``backend="stacked"`` (``"auto"``): one block of all N_T users, the
    sharded engine's one-shard mesh; the exchange is one product with the
    row-normalized mixing matrix W (``kernels.gossip_mix_block`` hands a
    halo of 0 rows to ``gossip_mix_all``), read straight from the flat
    buffer, and the self-weighted update ``p ← self_w · p + W · msgs``.
  - ``backend="sharded"``: one block of ``m = ceil(N_T / S)`` users per
    shard of a ``launch.sharding.UserMesh`` (padded with inert users: zero
    data, self weight 1, no edges, loss mask 0).  After every shard has
    compressed, the boundary rows (senders with an edge into another shard)
    are gathered into one ``(S·B, L)`` halo per distinct device of the mesh
    (``repro``'s ``all_gather``); then each shard mixes its own slab under
    its intra-shard block ``Wb (m, m)`` and the halo under its cross-shard
    block ``Wh (m, S·B)`` in one kernel (``kernels.gossip_mix_block``) and
    updates its replicas.  A single controller drives the shards one after
    another; a mesh may list one card several times.
  - ``backend="reference"``: one block per user (the CNN as a population
    of one: ``repro``'s per-user loop); receiver j averages the
    ``(indeg_j + 1, L)`` stack of its own model and its messages, in edge
    order, with weights ``[self_w_j, w_edge, …]``
    (``kernels.gossip_mix``).  A user with no incoming edge keeps its
    model.

The host tracks the data cursor and epoch as Python ints (every user has
the same chunk and batch size), and reads one number per round: the mean
loss.  Epoch 0 walks each user's shard in order, as ``repro`` does; later
epochs draw one ``(N_T, chunk)`` permutation table per epoch from a CPU
``torch.Generator`` seeded from ``seed`` (``repro`` draws them from JAX's
PRNG, which the port cannot reproduce), or take it from a caller-given
``(N_T, epochs, chunk)`` table, as the parity tests do with ``repro``'s.
Every engine cuts its blocks' rows from that one table (padding users walk
their zeros in order), so real users see the same batches in every engine
and at every shard count.
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
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_block
from repro_torch.launch.sharding import FLSharding, UserMesh, pad_edge_lists
from repro_torch.train.compression import Int8, TopK, int8_scale, topk_count
from repro_torch.train.optim import SGDM
from repro_torch.train.tree import ParamLayout

BACKENDS = ("auto", "reference", "stacked", "sharded")


@dataclasses.dataclass
class GossipConfig:
    local_steps: int = 4          # minibatch steps per round (one chunk)
    batch_size: int = 64
    lr: float = 0.05
    momentum: float = 0.9
    aggregate_self_weight: float = 0.5   # weight of own model in the average
    compressor: Any = None        # repro_torch.train.compression.TopK / Int8 / None
    backend: str = "auto"         # "reference" | "stacked" | "sharded" | "auto" (= stacked)
    # Sharded engine only: the shard count when the trainer builds its own
    # mesh (None = every visible card; on the CPU, one shard).
    num_shards: int | None = None


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
    edges accumulate.
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


def shard_edge_arrays(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, fls: FLSharding
) -> tuple[dict, dict]:
    """Host-side partition of the mixing edges per receiver shard: the
    boundary lists and dense mixing blocks of ``repro``'s
    ``GossipTrainer._shard_edge_arrays`` (the same values).

      - ``b_idx`` (S, B): local indices of the users of each shard with an
        out-edge leaving it, the only rows the halo gathers; ragged lists
        are padded to B with index 0 (under a zero column of ``Wh``);
      - ``Wb`` (S, m, m): the intra-shard block, ``Wb[s, j, i]`` the weight
        of local sender i at local receiver j;
      - ``Wh`` (S, m, S·B): the cross-shard block; halo row ``s·B + k`` is
        the k-th boundary sender of shard s.

    Duplicate edges accumulate.  ``repro``'s edge lists (``i_src`` …) feed
    only its segment-sum exchange, which the port does not have.  Returns
    ``(arrays, halo_stats)``: the exchange volume, halo rows each shard
    receives per round against the dense all-pairs alternative.
    """
    S, m = fls.num_shards, fls.block_size
    s_src = src // m
    s_dst = dst // m
    intra = s_src == s_dst
    cross = ~intra

    bnd = [np.unique(src[cross & (s_src == s)]) - s * m for s in range(S)]
    b_idx, _ = pad_edge_lists(bnd)
    b = b_idx.shape[1]
    # halo row of global sender u = (u's shard) · B + u's position in that
    # shard's boundary list
    halo_pos = np.full(fls.num_padded, -1, np.int64)
    for s in range(S):
        halo_pos[s * m + bnd[s]] = s * b + np.arange(len(bnd[s]))

    wb = np.zeros((S, m, m), np.float32)
    wh = np.zeros((S, m, S * b), np.float32)
    if intra.any():
        np.add.at(wb, (s_dst[intra], dst[intra] % m, src[intra] % m), w[intra])
    if cross.any():
        np.add.at(wh, (s_dst[cross], dst[cross] % m, halo_pos[src[cross]]), w[cross])

    halo_stats = {
        "num_shards": S,
        "block_size": m,
        "intra_edges": int(np.sum(intra)),
        "cross_edges": int(np.sum(cross)),
        "boundary_rows": int(sum(len(r) for r in bnd)),
        # rows each shard RECEIVES per round (padded gather width)
        "halo_rows_per_shard": S * b,
        # rows the dense all-pairs alternative would receive
        "dense_rows_per_shard": fls.num_padded,
    }
    return {"b_idx": b_idx, "Wb": wb, "Wh": wh}, halo_stats


class _Block:
    """Contiguous users ``[lo, lo + rows)`` on one device: their replicas,
    momentum, error-feedback residual, messages, mixes and data."""

    def __init__(self, common: dict, lo: int, xs: torch.Tensor, ys: torch.Tensor,
                 compressed: bool, mask: torch.Tensor | None = None):
        self.lo, self.rows, self.device = lo, int(xs.shape[0]), xs.device
        self.model = StackedCNN(common, self.rows, self.device)
        flat = self.model.flat
        self.momentum = torch.zeros_like(flat, requires_grad=False)
        self.residual = torch.zeros_like(self.momentum) if compressed else None
        self.msgs = torch.empty_like(self.momentum) if compressed else None
        # each (user, leaf)'s threshold or scale, filled every round
        self.stats = (torch.empty((self.rows, len(self.model.layout.columns())),
                                  device=self.device) if compressed else None)
        self.incoming = torch.empty_like(self.momentum)
        self.xs, self.ys = xs, ys.long()
        self.mask = mask              # (rows,) loss weights; None = every row counts
        self.rows_idx = torch.arange(self.rows, device=self.device)[:, None]
        self.perm = torch.arange(xs.shape[1], device=self.device).expand(self.rows, -1)

    def local_step(self, opt: SGDM, cursor: int | torch.Tensor, batch: int) -> torch.Tensor:
        """One SGDM step of every user; the (masked) sum of their losses.
        ``cursor`` is the offset into every user's data order, or a
        (rows, batch) tensor of each user's sample indices."""
        idx = self.perm[:, cursor:cursor + batch] if isinstance(cursor, int) else cursor
        x, y = self.xs[self.rows_idx, idx], self.ys[self.rows_idx, idx]
        flat = self.model.flat
        flat.grad = None
        losses = self.model.losses(x, y)
        losses.sum().backward()            # the sum: every user's own gradient
        opt.update_(flat, flat.grad, self.momentum)
        losses = losses.detach()
        return (losses if self.mask is None else losses * self.mask).sum()

    @torch.no_grad()
    def compress(self, comp, columns) -> torch.Tensor:
        """This round's messages; updates the error-feedback residual."""
        flat = self.model.flat
        if comp is None:
            return flat.detach()
        msgs = torch.add(flat, self.residual, out=self.msgs)     # the delta
        if isinstance(comp, TopK):
            kernel = topk_mask

            def stat(x):           # the k-th largest |x| of each row
                return torch.topk(torch.abs(x), topk_count(comp.fraction, x.shape[1]),
                                  dim=1).values[:, -1]
        else:
            kernel, stat = int8_roundtrip, int8_scale
        # every leaf's statistic from the unmodified delta, then one launch over all leaves
        torch.stack([stat(msgs[:, a:b]) for a, b in columns], dim=1, out=self.stats)
        kernel(msgs, self.stats, columns=columns, out=(msgs, self.residual))
        return msgs


class GossipTrainer:
    """Holds every user's replica and runs gossip rounds.

    ``step_round() -> {"round", "mean_loss", "dropped_samples"}``;
    ``user_params(i)`` / ``params`` read replicas back as trees of numpy
    arrays in ``repro``'s layout; ``user_flat(i)`` is user i's flat replica
    on its device.

    ``init_params`` is either a callable ``(torch.Generator) -> tree`` (for
    example ``fl.cnn.init_cnn_params`` with the data's shape), called once
    with a CPU generator seeded from ``seed``, or the tree itself; every
    user starts from it.  The model is the paper's CNN (``fl.cnn``): unlike
    ``repro``'s trainer this one takes no loss function, because its batched
    forward is written out for that model.  ``device=None`` means the CUDA
    card (``RuntimeError`` without one); ``device="cpu"`` runs the kernels'
    plain versions.  ``epoch_perms`` (``(N_T, E, chunk)``, epoch e ≥ 1 uses
    ``epoch_perms[:, e - 1]``) replaces the trainer's own reshuffles.

    The sharded engine runs on ``user_mesh`` (a ``launch.sharding.UserMesh``
    whose devices are of ``device``'s type), or builds one of
    ``cfg.num_shards`` shards: over the visible cards for a CUDA device,
    over ``["cpu"] * num_shards`` for the CPU.  The stacked engine is the
    mesh of one shard on ``device``.  ``halo_stats`` reports the exchange
    volume and ``edge_arrays`` the per-shard mixing blocks.

    ``stage_events``: set it to a list to have each CUDA round append
    ``(stage, torch.cuda.Event)`` at its start and after its local steps,
    its compression, its halo gather (sharded only) and its exchange, on
    the current device (``chip_smoke.py`` times the stages with them).
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
        user_mesh: UserMesh | None = None,
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

        common = init_params(torch.Generator().manual_seed(seed)) if callable(init_params) \
            else init_params
        self.layout = ParamLayout(common)
        self.opt = SGDM(learning_rate=self.cfg.lr, momentum=self.cfg.momentum)
        self_w, src, dst, w_edge, _ = mixing_arrays(task_graph, self.cfg.aggregate_self_weight)
        if self.backend == "reference":
            self._init_reference(common, xs, ys, self_w, w_edge)
        else:   # the stacked engine is the one-shard mesh on ``device``
            mesh = UserMesh((self.device,)) if self.backend == "stacked" else user_mesh
            self._init_sharded(common, xs, ys, self_w, src, dst, w_edge, mesh)

        self._perm_gen = torch.Generator().manual_seed(seed * 1_000_003 + 0x0DA7A)
        self._cursor = 0
        self._epoch = 0
        self.round = 0
        self.stage_events: list | None = None

    @staticmethod
    def _resolve_backend(backend: str) -> str:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        return "stacked" if backend == "auto" else backend

    # -- engines ------------------------------------------------------------
    def _init_sharded(self, common, xs, ys, self_w, src, dst, w_edge, user_mesh) -> None:
        if user_mesh is None:
            shards = self.cfg.num_shards
            user_mesh = (UserMesh.build(shards) if self.device.type == "cuda"
                         else UserMesh.build(shards, devices=["cpu"] * (shards or 1)))
        if any(d.type != self.device.type for d in user_mesh.devices):
            raise ValueError(f"the mesh's devices {user_mesh.devices} are not all of the "
                             f"trainer's type {self.device.type!r}")
        for d in set(user_mesh.devices):
            resolve_device(d)
        self.user_mesh = user_mesh
        self._fls = fls = FLSharding(user_mesh=user_mesh, num_users=self.n)
        m = self._block_size = fls.block_size
        self.edge_arrays, self.halo_stats = shard_edge_arrays(src, dst, w_edge, fls)
        data = fls.shard((fls.pad_users(xs), fls.pad_users(ys),
                          fls.pad_users(self_w, fill=1.0),
                          fls.valid_mask().astype(np.float32)))
        consts = fls.shard_blocks(self.edge_arrays)
        self._blocks = []
        for s, ((x, y, sw, mask), c) in enumerate(zip(data, consts)):
            blk = _Block(common, s * m, x, y, self.cfg.compressor is not None,
                         mask=None if fls.num_padding == 0 else mask)
            blk.self_w, blk.Wb, blk.Wh = sw[:, None], c["Wb"], c["Wh"]
            blk.b_idx = c["b_idx"].long()
            self._blocks.append(blk)
        self._halo_width = self.edge_arrays["b_idx"].shape[1]
        # one gathered halo per distinct device of the mesh
        self._halos = {}
        for blk in self._blocks:
            if blk.device not in self._halos:
                self._halos[blk.device] = torch.empty(
                    (fls.num_shards * self._halo_width, self.layout.size), device=blk.device)

    def _init_reference(self, common, xs, ys, self_w, w_edge) -> None:
        dev = self.device
        comp = self.cfg.compressor is not None
        self._blocks = [_Block(common, i, torch.from_numpy(xs[i:i + 1]).to(dev),
                               torch.from_numpy(ys[i:i + 1]).to(dev), comp)
                        for i in range(self.n)]
        self._block_size = 1
        senders: list[list[int]] = [[] for _ in range(self.n)]
        weights: list[list[float]] = [[] for _ in range(self.n)]
        for (i, j), w in zip(self.g.edges, w_edge):
            senders[j].append(i)
            weights[j].append(float(w))
        # receivers with incoming edges: (j, senders in edge order, [self_w_j, w_edge, …])
        self._receivers = [
            (j, senders[j], torch.tensor([float(self_w[j])] + weights[j], device=dev))
            for j in range(self.n) if senders[j]
        ]
        rows = 1 + max((len(s) for s in senders), default=0)
        self._stack = torch.empty((rows, self.layout.size), device=dev)

    @torch.no_grad()
    def _exchange(self, msgs: list[torch.Tensor]) -> None:
        blocks = self._blocks
        if self.backend != "reference":
            # the halo is a copy taken after every shard compressed and before
            # any shard updates: a shard never mixes a half-updated neighbour
            B = self._halo_width
            if B:
                for s, (blk, msg) in enumerate(zip(blocks, msgs)):
                    rows = msg.index_select(0, blk.b_idx)
                    for halo in self._halos.values():
                        halo[s * B:(s + 1) * B].copy_(rows)
            self._mark("halo")
            for blk, msg in zip(blocks, msgs):
                gossip_mix_block(msg, blk.Wb, self._halos[blk.device], blk.Wh, out=blk.incoming)
                blk.model.flat.mul_(blk.self_w).add_(blk.incoming)
        else:
            for j, senders, w in self._receivers:
                tensors = [blocks[j].model.flat.detach()] + [msgs[i] for i in senders]
                stack = torch.cat(tensors, out=self._stack[:len(tensors)])
                gossip_mix(stack, w, out=blocks[j].incoming[0])
            for j, _, _ in self._receivers:      # every receiver read the old models
                blocks[j].model.flat.copy_(blocks[j].incoming)

    # -- replica access -----------------------------------------------------
    def user_flat(self, i: int) -> torch.Tensor:
        """User i's flat replica (L,), a view on its block's device."""
        if not 0 <= i < self.n:
            raise IndexError(f"user {i} of {self.n}")
        blk = self._blocks[i // self._block_size]
        return blk.model.flat[i % self._block_size].detach()

    def user_params(self, i: int) -> dict:
        """User i's parameters as a tree of numpy arrays (``repro``'s layout)."""
        return self.layout.unflatten(self.user_flat(i).to("cpu", copy=True).numpy())

    @property
    def params(self) -> list:
        return [self.user_params(i) for i in range(self.n)]

    # -- one round ----------------------------------------------------------
    def _epoch_perm(self, epoch: int) -> torch.Tensor:
        """The (N_T, chunk) data order of epoch ≥ 1, on the CPU."""
        if self._epoch_perms is None:
            keys = torch.rand((self.n, self._chunk), generator=self._perm_gen)
            return torch.argsort(keys, dim=1)
        if epoch > self._epoch_perms.shape[1]:
            raise ValueError(f"epoch {epoch} is past the {self._epoch_perms.shape[1]} "
                             "epochs of the given permutation table")
        return torch.from_numpy(self._epoch_perms[:, epoch - 1])

    def _advance(self) -> int:
        """The cursor of the next step; a new epoch reshuffles every block."""
        batch = self.cfg.batch_size
        if self._cursor + batch > self._chunk:
            self._epoch += 1
            perm = self._epoch_perm(self._epoch)
            pad = sum(b.rows for b in self._blocks) - self.n
            if pad:                                # padding users walk their zeros in order
                perm = torch.cat([perm, torch.arange(self._chunk).expand(pad, -1)])
            for blk in self._blocks:
                blk.perm = perm[blk.lo:blk.lo + blk.rows].to(blk.device)
            self._cursor = 0
        cursor = self._cursor
        self._cursor += batch
        return cursor

    def _mark(self, stage: str) -> None:
        if self.stage_events is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((stage, ev))

    def step_round(self) -> dict:
        """One gossip round: local training, compression, exchange, average."""
        self._mark("start")
        sums = []
        for _ in range(self.cfg.local_steps):
            cursor = self._advance()
            sums += [blk.local_step(self.opt, cursor, self.cfg.batch_size)
                     for blk in self._blocks]
        self._mark("local")
        cols = self.layout.columns()
        msgs = [blk.compress(self.cfg.compressor, cols) for blk in self._blocks]
        self._mark("compress")
        self._exchange(msgs)
        self._mark("mix")
        self.round += 1
        dev = self._blocks[0].device
        total = float(torch.stack([s.to(dev) for s in sums]).sum())
        return {
            "round": self.round,
            "mean_loss": total / (self.n * self.cfg.local_steps),
            "dropped_samples": self.dropped_samples,
        }
