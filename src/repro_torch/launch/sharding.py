"""The gossip-FL user mesh and the LM's mesh rules (counterpart of
``repro.launch.sharding``).

The sharded engine (``repro_torch.fl.gossip``, ``backend="sharded"``)
splits the population into contiguous user blocks, one per shard, padded
with inert users when ``N_T % shards != 0``.  ``repro`` runs that engine
as one ``shard_map`` over a 1-D device mesh from a single controller; the
port keeps the single controller: one process drives a mesh that is a list
of ``torch.device``s, one per shard.  A device may appear more than once:

  - ``UserMesh.build(8)``: the first 8 visible CUDA cards;
  - ``UserMesh.build(8, devices=["cuda:0"] * 8)``: eight shards on one
    card, run one after another (the counterpart of ``repro``'s
    ``--xla_force_host_platform_device_count=8``);
  - ``UserMesh.build(8, devices=["cpu"] * 8)``: the CPU mesh of the tests.

``FLSharding`` places one population on a mesh: ``shard`` splits
user-leading arrays into per-shard blocks, each on its shard's device (the
counterpart of ``device_put`` with ``P("users")``), and ``shard_blocks``
does the same for per-shard constants whose leading axis is the shard.

The LM's mesh (the other half of ``repro.launch.sharding``):
``MeshRules`` and the spec helpers ``param_spec`` / ``param_specs``,
``batch_specs`` and ``make_rules``.  A spec is ``repro``'s
``PartitionSpec`` as a tuple, one entry a tensor dim: ``None``, an axis
name, or a tuple of axis names (the data axes, ``("pod", "data")`` on the
multi-pod mesh).  ``placements(spec, names)`` turns it into DTensor
placements, one a mesh dim: ``Shard(d)`` where the spec names that mesh dim
at tensor dim d, else ``Replicate()``.  ``MeshRules`` reads the mesh's dim
names and sizes only (``AbstractMesh`` stands in for a ``DeviceMesh`` where
no process group runs); ``constrain`` (``repro``'s
``with_sharding_constraint``: ``DTensor.redistribute``) and the ``place_*``
helpers alone touch the ``DeviceMesh``.  The LM leaves are the port's
(``LM.named_parameters()``: ``blocks.3.wq``), one a layer; each gets the
spec ``repro`` gives the leaf that ``convert._lm_leaf`` maps it to, less
the leading stacked dim.  The placements come from these specs, not from
FSDP or ``parallelize_module`` plans (``repro`` places ``wo`` as (tp,
fsdp), FSDP2 would shard its dim 0 over the data axes).

The decode cache: ``cache_specs(cache, rules)`` (``repro``'s
``cache_shardings``) lays each of the port's kind-stacked entries out as
``repro`` lays out one layer's, behind a whole leading layer dim: the batch
over the data axes where they divide it, the slots of the attention caches
(``k``, ``v``, ``local_k``, ``local_v``; Whisper's ``enc_k``, ``enc_v``)
over the tensor axis where it divides them (and ``seq_shard_decode``),
the Mamba-2 and RG-LRU states by batch alone.  ``MeshRules.place_cache`` places a cache so, and
``MeshRules.sharded_decode_attention`` is the decode attention over it
(``models.attention.sharded_decode_attention``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, ClassVar, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import TP_AXIS
from repro_torch.models.attention import sharded_decode_attention
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class UserMesh:
    """One device per shard of the FL user axis (devices may repeat)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("need >= 1 shard, got 0")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def build(cls, num_shards: int | None = None,
              devices: Sequence[str | torch.device] | None = None) -> "UserMesh":
        """Mesh over ``devices``, or over the first ``num_shards`` visible
        CUDA cards (all of them by default).

        Without ``devices`` it raises ``RuntimeError`` when there is no CUDA
        card, and ``ValueError`` when fewer cards than shards are visible:
        several shards share a card only when the caller lists it several
        times.
        """
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "UserMesh.build needs a CUDA device (none is available); pass "
                    "devices=['cpu'] * num_shards to shard on the CPU"
                )
            visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            num_shards = len(visible) if num_shards is None else num_shards
            if num_shards < 1:
                raise ValueError(f"need >= 1 shard, got {num_shards}")
            if num_shards > len(visible):
                raise ValueError(
                    f"requested {num_shards} user shards but only {len(visible)} CUDA "
                    f"device(s) are visible; pass devices=['cuda:0'] * {num_shards} to "
                    "run several shards on one card"
                )
            return cls(tuple(visible[:num_shards]))
        devs = tuple(torch.device(d) for d in devices)
        num_shards = len(devs) if num_shards is None else num_shards
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        if len(devs) != num_shards:
            raise ValueError(f"{len(devs)} devices listed for {num_shards} shards")
        return cls(devs)

    @property
    def num_shards(self) -> int:
        return len(self.devices)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


@dataclasses.dataclass(frozen=True)
class FLSharding:
    """Placement of one FL population on a :class:`UserMesh`.

    Knows the padded user count (``N_T`` rounded up to a multiple of the
    shard count), pads host arrays with inert users, and splits user-leading
    arrays into per-shard blocks on the shards' devices.
    """

    user_mesh: UserMesh
    num_users: int

    def __post_init__(self):
        if self.num_users < 1:
            raise ValueError(f"need >= 1 user, got {self.num_users}")

    @property
    def num_shards(self) -> int:
        return self.user_mesh.num_shards

    @property
    def block_size(self) -> int:
        """Users per shard (after padding)."""
        return -(-self.num_users // self.num_shards)

    @property
    def num_padded(self) -> int:
        """``N_T`` rounded up to a multiple of the shard count."""
        return self.block_size * self.num_shards

    @property
    def num_padding(self) -> int:
        return self.num_padded - self.num_users

    def shard_of(self) -> np.ndarray:
        """(num_padded,) shard id of each (padded) user slot."""
        return np.arange(self.num_padded) // self.block_size

    def valid_mask(self) -> np.ndarray:
        """(num_padded,) bool: True for real users, False for padding."""
        return np.arange(self.num_padded) < self.num_users

    def pad_users(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Pad a host array's leading user axis to ``num_padded``."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.num_users:
            raise ValueError(f"leading axis {arr.shape[0]} != num_users {self.num_users}")
        if not self.num_padding:
            return arr
        widths = [(0, self.num_padding)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill)

    def shard(self, tree: Any) -> list:
        """A tree of user-leading arrays (already padded) -> one tree per
        shard, holding rows ``[s·m, (s+1)·m)`` on shard s's device."""
        m = self.block_size

        def check(leaf):
            if leaf.shape[0] != self.num_padded:
                raise ValueError(f"leaf leading axis {leaf.shape[0]} != padded user count "
                                 f"{self.num_padded}; pad_users() first")

        _map(check, tree)
        return [_map(lambda x, s=s, d=d: _tensor(x[s * m:(s + 1) * m]).to(d), tree)
                for s, d in enumerate(self.user_mesh.devices)]

    def shard_blocks(self, tree: Any) -> list:
        """A tree of per-shard constants (leading axis = shard) -> one tree
        per shard, holding block s on shard s's device."""

        def check(leaf):
            if leaf.shape[0] != self.num_shards:
                raise ValueError(f"leaf leading axis {leaf.shape[0]} != shard count "
                                 f"{self.num_shards}")

        _map(check, tree)
        return [_map(lambda x, s=s, d=d: _tensor(x[s]).to(d), tree)
                for s, d in enumerate(self.user_mesh.devices)]


def pad_edge_lists(rows: Sequence[np.ndarray], fill: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged per-shard index lists into a dense (S, E_max) array.

    Returns ``(stacked, lengths)``; positions past each row's length hold
    ``fill``: callers pair them with zero weights, so padded entries are
    exact no-ops in the mix.
    """
    lengths = np.asarray([len(r) for r in rows], dtype=np.int64)
    e_max = int(lengths.max()) if len(rows) else 0
    out = np.full((len(rows), e_max), fill, dtype=np.int32)
    for s, r in enumerate(rows):
        out[s, : len(r)] = r
    return out, lengths


# ---------------------------------------------------------------------------
# LM mesh rules (FSDP × TP × SP layouts)
# ---------------------------------------------------------------------------


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names without devices (``DeviceMesh``'s
    ``shape`` and ``mesh_dim_names``): enough for every spec."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def placements(spec: tuple, names: Sequence[str]) -> list:
    """DTensor placements of ``spec`` on a mesh with dims ``names``."""
    out = []
    for name in names:
        pl = Replicate()
        for d, entry in enumerate(spec):
            if name == entry or (isinstance(entry, tuple) and name in entry):
                pl = Shard(d)
        out.append(pl)
    return out


@dataclasses.dataclass
class MeshRules:
    """Activation layouts of the LM on a mesh (``repro``'s ``MeshRules``):
    tensor parallelism over ``model``, and ``repro``'s three overrides at
    their defaults: FSDP over ``fsdp_axis`` ("data"), the residual split by
    sequence over the tensor axis (``sequence_parallel``) and the
    attention caches split by slots over it (``seq_shard_decode``)."""

    mesh: Any                     # a DeviceMesh, or an AbstractMesh for specs alone
    cfg: ModelConfig
    fsdp_axis: str = "data"
    sequence_parallel: bool = True
    seq_shard_decode: bool = True
    tp_axis: ClassVar[str] = TP_AXIS

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def size(self, axis: str) -> int:
        return int(dict(zip(self.names, self.mesh.shape))[axis])

    @property
    def dp(self) -> tuple[str, ...]:
        return tuple(a for a in self.names if a != self.tp_axis)

    @property
    def tp_size(self) -> int:
        return self.size(self.tp_axis)

    @property
    def dp_size(self) -> int:
        out = 1
        for a in self.dp:
            out *= self.size(a)
        return out

    @property
    def shard_heads(self) -> bool:
        return _divisible(self.cfg.num_heads, self.tp_size)

    def constrain(self, x, kind: str):
        """``x`` redistributed to the layout of ``kind`` (a DTensor; any
        other ``x``, or a kind without a layout, passes as it is).  A dim
        that its axes do not divide stays whole: GSPMD pads such a dim,
        DTensor would split it unevenly (the same numbers either way)."""
        spec = self.spec_for(kind, tuple(x.shape))
        if spec is None or not isinstance(x, DTensor):
            return x
        even = tuple(e if x.shape[d] % self._axes_size(e) == 0 else None
                     for d, e in enumerate(spec))
        return x.redistribute(self.mesh, self.placements(even))

    def placements(self, spec: tuple) -> list:
        """``placements(spec, names)``, with ``Replicate()`` on a mesh dim of
        size 1 (where a split is no split, and DTensor refuses some views of
        a dim "split" over it)."""
        return [Replicate() if n == 1 else p
                for n, p in zip(self.mesh.shape, placements(spec, self.names))]

    def _axes_size(self, entry) -> int:
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out = 1
        for a in axes:
            out *= self.size(a)
        return out

    def spec_for(self, kind: str, shape: tuple[int, ...]) -> tuple | None:
        dp, tp = self.dp, self.tp_axis
        if kind == "hidden":                      # (B, S, D)
            if self.sequence_parallel and _divisible(shape[1], self.tp_size):
                return (dp, tp, None)
            return (dp, None, None)
        if kind == "hidden_decode":               # (B, 1, D)
            return (dp, None, None)
        if kind in ("heads", "kv_heads"):         # (B, S, H or Hkv, hd)
            if self.shard_heads and _divisible(shape[2], self.tp_size):
                return (dp, None, tp, None)
            return (dp, None, None, None)
        if kind == "ffn":                         # (B, S, F)
            if _divisible(shape[2], self.tp_size):
                return (dp, None, tp)
            return (dp, None, None)
        if kind == "logits":                      # (B, S, V)
            return (dp, None, tp)
        if kind == "logits_decode":               # (B, V)
            return (dp, tp)
        if kind == "cache":                       # (B, S, Hkv, hd) seq-sharded
            b_spec = dp if _divisible(shape[0], self.dp_size) else None
            if self.seq_shard_decode and _divisible(shape[1], self.tp_size):
                return (b_spec, tp, None, None)
            return (b_spec, None, None, None)
        if kind == "moe_tokens":                  # (B, E, C, D)
            e_spec = tp if _divisible(shape[1], self.tp_size) else None
            return (dp if _divisible(shape[0], self.dp_size) else None, e_spec, None, None)
        if kind == "moe_hidden":                  # (B, E, C, F)
            b_spec = dp if _divisible(shape[0], self.dp_size) else None
            if _divisible(shape[1], self.tp_size):
                return (b_spec, tp, None, None)
            if _divisible(shape[3], self.tp_size):
                return (b_spec, None, None, tp)
            return (b_spec, None, None, None)
        return None

    # -- placing host tensors on the mesh ---------------------------------
    def place(self, t: torch.Tensor, spec: tuple) -> DTensor:
        """``t`` (the same full tensor on every rank) as a DTensor laid out
        by ``spec``: each rank keeps its own chunk, nothing is sent."""
        return distribute_tensor(t, self.mesh, self.placements(spec), src_data_rank=None)

    @torch.no_grad()
    def place_param(self, module: nn.Module, name: str, whole: torch.Tensor) -> None:
        """Set ``module``'s parameter ``name`` to ``whole`` laid out by
        ``param_spec``."""
        owner, _, leaf = name.rpartition(".")
        dt = self.place(whole, param_spec(name, tuple(whole.shape), self))
        setattr(module.get_submodule(owner), leaf, nn.Parameter(dt, requires_grad=False))

    def place_params(self, module: nn.Module) -> nn.Module:
        """Swap every parameter of ``module`` for a DTensor laid out by
        ``param_spec``, in place; returns ``module``."""
        for name, p in list(module.named_parameters()):
            self.place_param(module, name, p.detach())
        return module

    def place_batch(self, batch: dict, device) -> dict:
        """A batch of full arrays as DTensors laid out by ``batch_specs``
        (DTensors pass as they are)."""
        batch = {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        specs = batch_specs(batch, self)
        return {k: v if isinstance(v, DTensor) else self.place(v, specs[k])
                for k, v in batch.items()}

    def place_cache(self, cache: dict) -> dict:
        """A decode cache of full tensors as DTensors laid out by
        ``cache_specs``."""
        specs = cache_specs(cache, self)
        return {k: self.place(v, specs[k]) for k, v in cache.items()}

    def sharded_decode_attention(self, q, k_cache, v_cache, valid_len):
        """q (B, H, hd), the caches laid out by ``cache_specs``, valid_len (B,)
        -> (B, H, hd): row 10's partials over each rank's slots merged over the
        tensor axis, or, where it does not divide the slots, the kernel over
        the whole cache on each rank's rows."""
        return sharded_decode_attention(q, k_cache, v_cache, valid_len, self)


# ---------------------------------------------------------------------------
# Parameter and batch specs
# ---------------------------------------------------------------------------


def param_spec(name: str, shape: tuple[int, ...], rules: MeshRules) -> tuple:
    """The spec of one parameter, by its name in ``LM.named_parameters()``
    (or ``Whisper``'s) and its shape: ``repro``'s ``_param_spec`` of the
    leaf it maps to, less the stacked dim."""
    cfg, tp, fsdp = rules.cfg, rules.tp_axis, rules.fsdp_axis
    tps, fs = rules.tp_size, rules.size(fsdp)

    def build(spec_core: tuple) -> tuple:
        return tuple(spec_core) + (None,) * (len(shape) - len(spec_core))

    def ok(axis_len, size):
        return _divisible(axis_len, size)

    heads_shardable = rules.shard_heads
    kv_shardable = heads_shardable and _divisible(cfg.num_kv_heads, tps)
    if re.search(r"\bembed\b", name):
        return build((tp if ok(shape[0], tps) else None, fsdp if ok(shape[1], fs) else None))
    if "lm_head" in name:
        return build((fsdp if ok(shape[0], fs) else None, tp if ok(shape[1], tps) else None))
    if re.search(r"w[qk]|wv", name) and len(shape) == 2:
        out_ok = ok(shape[1], tps) and (kv_shardable if re.search(r"w[kv]", name)
                                       else heads_shardable)
        return build((fsdp if ok(shape[0], fs) else None, tp if out_ok else None))
    if "wo" in name:
        return build((tp if (heads_shardable and ok(shape[0], tps)) else None,
                      fsdp if ok(shape[1], fs) else None))
    if re.search(r"w_gate|w_up", name) and len(shape) == 3:      # MoE (E, D, F)
        if ok(shape[0], tps):
            return build((tp, fsdp if ok(shape[1], fs) else None, None))
        return build((None, fsdp if ok(shape[1], fs) else None, tp if ok(shape[2], tps) else None))
    if "w_down" in name and len(shape) == 3:                     # MoE (E, F, D)
        if ok(shape[0], tps):
            return build((tp, None, fsdp if ok(shape[2], fs) else None))
        return build((None, tp if ok(shape[1], tps) else None, fsdp if ok(shape[2], fs) else None))
    if re.search(r"w_gate|w_up", name):
        return build((fsdp if ok(shape[0], fs) else None, tp if ok(shape[1], tps) else None))
    if "w_down" in name:
        return build((tp if ok(shape[0], tps) else None, fsdp if ok(shape[1], fs) else None))
    if "router" in name:
        return build((fsdp if ok(shape[0], fs) else None, None))
    # SSM: the fused in_proj stays whole on its out dim (mixed segments);
    # out_proj shards d_inner over tp
    if "in_proj" in name and len(shape) == 2:
        return build((fsdp if ok(shape[0], fs) else None,
                      tp if ("in_proj_" in name and ok(shape[1], tps)) else None))
    if "out_proj" in name:
        return build((tp if ok(shape[0], tps) else None, fsdp if ok(shape[1], fs) else None))
    if re.search(r"gate_[ax]_w", name):
        return build((fsdp if ok(shape[0], fs) else None, tp if ok(shape[1], tps) else None))
    return build(())                             # 1-D scales, biases, conv kernels


def param_specs(params: nn.Module, rules: MeshRules) -> dict[str, tuple]:
    """``{name: spec}`` of every parameter of an ``LM`` or a ``Whisper``."""
    return {n: param_spec(n, tuple(p.shape), rules) for n, p in params.named_parameters()}


def batch_specs(batch: dict, rules: MeshRules) -> dict[str, tuple]:
    """Every batch input sharded over the data axes on its batch dim (dim 1
    of M-RoPE's (3, B, S) positions); a batch the data axes do not divide
    stays whole (``repro``'s ``batch_shardings``)."""
    dp = rules.dp

    def spec(shape) -> tuple:
        if len(shape) == 0:
            return ()
        if len(shape) >= 2 and shape[0] == 3:           # (3, B, S) positions
            b_ok = _divisible(shape[1], rules.dp_size)
            return (None, dp if b_ok else None) + (None,) * (len(shape) - 2)
        b_ok = _divisible(shape[0], rules.dp_size)
        return (dp if b_ok else None,) + (None,) * (len(shape) - 1)

    return {k: spec(tuple(v.shape)) for k, v in batch.items()}


# the cache entries whose dim 2 (after the layer and the batch) is the slots
KV_CACHE_KEYS = ("k", "v", "local_k", "local_v", "enc_k", "enc_v")


def cache_specs(cache: dict, rules: MeshRules) -> dict[str, tuple]:
    """The spec of each entry of a kind-stacked decode cache (``init_cache``'s
    (L, B, …) tensors, or ``cache_specs``' meta ones): ``repro``'s
    ``cache_shardings`` of one layer behind the whole layer dim."""
    out = {}
    for key, t in cache.items():
        spec = [None] * t.dim()
        if _divisible(t.shape[1], rules.dp_size):
            spec[1] = rules.dp
        if rules.seq_shard_decode and key in KV_CACHE_KEYS and _divisible(t.shape[2],
                                                                         rules.tp_size):
            spec[2] = rules.tp_axis
        out[key] = tuple(spec)
    return out


def make_rules(cfg: ModelConfig, mesh, **kw) -> MeshRules:
    """``MeshRules`` of ``cfg`` on ``mesh``; ``kw`` sets ``repro``'s overrides
    (``fsdp_axis``, ``sequence_parallel``, ``seq_shard_decode``)."""
    return MeshRules(mesh=mesh, cfg=cfg, **kw)
