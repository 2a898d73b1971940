"""Collective traffic of a step and its roofline terms (counterpart of
``repro.launch.hlo_analysis``).

``repro`` parses the compiled per-device HLO for its collectives.  The
port has no compiled module: ``record_collectives()`` is a
``TorchDispatchMode`` that records every collective as it is dispatched on
this rank, the ``_c10d_functional`` ops that DTensor issues when it
redistributes and the ``c10d`` ops of an explicit ``dist.all_reduce`` (the
merge of row 10's partials).  Each record holds ``repro``'s kind, the bytes
of the op's output on this rank (what ``repro`` reads off the HLO
instruction's result shape) and the size of its process group.

``collective_stats(records)`` applies ``repro``'s ring model to them, per
device:

    all-reduce      2·(g−1)/g · bytes
    all-gather        (g−1)/g · full (gathered) bytes
    reduce-scatter    (g−1)/g · full (input) bytes = g · output bytes
    all-to-all        (g−1)/g · bytes
    collective-permute          bytes

(a broadcast, which ``repro``'s HLO never holds, counts its bytes once,
``repro``'s rule for any other collective).  DTensor's own
``_dtensor.shard_dim_alltoall`` (a shard-to-shard re-layout) is an
all-to-all.  ``roofline_terms`` keeps
``repro``'s formula with the NVIDIA H100 SXM's published rates as the
denominators.

The mode passes every op that has a DTensor argument on to DTensor
(``NotImplemented``) and stays on while DTensor dispatches it, so the
collectives that DTensor issues inside an op's dispatch (an input
redistributed to the layout its sharding strategy asks for) are recorded
as well.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 data sheet (700 W): dense bf16 tensor-core rate, HBM3
# bandwidth, and NVLink 4 at 900 GB/s both ways, 450 GB/s a direction.
H100_PEAK_FLOPS = 989e12        # FLOP/s
H100_HBM_BW = 3.35e12           # bytes/s
H100_NVLINK_BW = 450e9          # bytes/s, one direction

# op name (namespaces _c10d_functional and c10d) -> (repro's kind, the
# argument that holds the op's output, or None for its return value)
_OPS = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", None),
    "all_gather_into_tensor_coalesced": ("all-gather", None),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", None),
    "broadcast": ("broadcast", None),
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "output_tensors"),
    "_allgather_base_": ("all-gather", "output_tensor"),
    "allgather_into_tensor_coalesced_": ("all-gather", "outputs"),
    "reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "alltoall_": ("all-to-all", "output_tensors"),
    "alltoall_base_": ("all-to-all", "output"),
    "broadcast_": ("broadcast", "tensors"),
    "shard_dim_alltoall": ("all-to-all", None),      # DTensor's shard-to-shard re-layout
}
_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def _leaves(tree):
    """The leaves of the nested tuples, lists and dicts of an op's arguments
    (a flat walk: ``tree_flatten`` costs several µs a call)."""
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a (nested) tuple / list / dict."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def has_dtensor(args, kwargs) -> bool:
    return any(isinstance(a, DTensor) for a in _leaves((args, kwargs)))


def in_sharding_propagation() -> bool:
    """Whether the caller runs inside DTensor's sharding propagation, which
    runs each op once more on global-shape fake tensors to learn its
    output's shape (``ShardingPropagator._propagate_tensor_meta*``): work
    that no rank does."""
    f = sys._getframe(2)
    while f is not None:
        if "propagate_tensor_meta" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str               # repro's: all-reduce, all-gather, reduce-scatter, all-to-all, …
    op: str                 # the dispatched op, e.g. "_c10d_functional.all_reduce"
    out_bytes: int          # the op's output on this rank
    group_size: int


def _group_size(func, args, kwargs) -> int:
    named = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    if "group_name" in named:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(named["group_name"]).size()
    return dist.ProcessGroup.unbox(named["process_group"]).size()


def collective_record(func, args, kwargs, out) -> CollectiveRecord | None:
    """The record of one dispatched op, or None if it is no collective."""
    ns, _, rest = func.name().partition("::")
    name = rest.partition(".")[0]
    if ns not in _NAMESPACES or name not in _OPS:
        return None
    kind, where = _OPS[name]
    if where is None:
        data = out
    else:
        data = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)[where]
    return CollectiveRecord(kind, f"{ns}.{name}", tensor_bytes(data),
                            _group_size(func, args, kwargs))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched while it is on (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: list[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if has_dtensor(args, kwargs):
            return NotImplemented          # DTensor dispatches it, with this mode on
        out = func(*args, **kwargs)
        rec = collective_record(func, args, kwargs, out)
        if rec is not None:
            self.records.append(rec)
        self.seen(func, args, kwargs, out, rec)
        return out

    def seen(self, func, args, kwargs, out, rec) -> None:
        """A hook for subclasses: every local op, after it ran."""


def record_collectives() -> CollectiveRecorder:
    """``with record_collectives() as rec: ...`` -> ``rec.records``."""
    return CollectiveRecorder()


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict            # payload bytes by kind (per device)
    link_bytes: float            # ring-model link bytes (per device, total)

    def to_json(self):
        return {"counts": dict(self.counts),
                "bytes_by_op": {k: float(v) for k, v in self.bytes_by_op.items()},
                "link_bytes": float(self.link_bytes)}


def payload_and_link(kind: str, out_bytes: float, g: int) -> tuple[float, float]:
    """``repro``'s payload of one collective and its ring-model link bytes."""
    if kind == "all-gather":
        payload, factor = out_bytes, (g - 1) / g
    elif kind == "reduce-scatter":
        payload, factor = out_bytes * g, (g - 1) / g
    elif kind == "all-reduce":
        payload, factor = out_bytes, 2 * (g - 1) / g
    elif kind == "all-to-all":
        payload, factor = out_bytes, (g - 1) / g
    else:                                        # collective-permute, broadcast
        payload, factor = out_bytes, 1.0
    return payload, payload * factor


def collective_stats(records) -> CollectiveStats:
    counts: dict = defaultdict(int)
    raw: dict = defaultdict(float)
    link = 0.0
    for r in records:
        payload, lb = payload_and_link(r.kind, r.out_bytes, max(r.group_size, 1))
        counts[r.kind] += 1
        raw[r.kind] += payload
        link += lb
    return CollectiveStats(counts=dict(counts), bytes_by_op=dict(raw), link_bytes=link)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   link_bytes_per_device: float) -> dict:
    """``repro``'s three terms (s) and the dominant one, on the H100's rates."""
    terms = {"compute_s": flops_per_device / H100_PEAK_FLOPS,
             "memory_s": bytes_per_device / H100_HBM_BW,
             "collective_s": link_bytes_per_device / H100_NVLINK_BW}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
