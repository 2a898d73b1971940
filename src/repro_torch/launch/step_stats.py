"""FLOPs, bytes and collectives of one step on one rank (counterpart of
``repro.launch.hlo_stats.analyze_hlo``).

``repro`` reads its numbers off the compiled per-device HLO, loop trip
counts included.  The port has no compiled module: ``analyze_step(fn,
*args)`` runs the step once (on a fake world under ``FakeTensorMode`` in
the dry run, ``launch.dryrun``) and counts what this rank dispatches:

  - FLOPs: matrix products and convolutions only, as ``analyze_hlo`` counts
    ``dot`` and ``convolution``, by ``torch.utils.flop_counter``'s own
    formulas (``FlopCounterMode``'s table, ``flop_registry``), applied to
    each op on the rank's local tensors.  ``FlopCounterMode`` itself is not
    used as the mode: it sees DTensor's ops at their global shapes and the
    sharding propagation's extra run of each op, neither of which any rank
    computes.  The backward's products count, and under ``remat`` the
    forward's again in the backward (the recompute).
  - Bytes: the operand and output bytes of every dispatched non-view op
    (views, ``empty*`` and ``wait_tensor`` move nothing; an in-place op's
    output is its operand, counted once): the memory
    traffic of an unfused eager run, each op reading its inputs from memory
    and writing its outputs back.  ``analyze_hlo`` counts the same for the
    top-level ops of the fused module, so this is larger by what XLA's
    fusion saves.
  - Collectives: ``launch.collectives``' records and ring model.

The port's kernel wrappers take their plain versions on (fake) CPU tensors:
their communication is the card's, and their FLOPs are the same products
(the plain attention computes the whole S_q × S_k logits where the kernel
skips causal tiles above the diagonal).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.collectives import (
    CollectiveRecorder,
    collective_stats,
    in_sharding_propagation,
    tensor_bytes,
)

_NO_TRAFFIC = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
               "aten::new_empty_strided", "_c10d_functional::wait_tensor"}


@dataclasses.dataclass
class StepStats:
    """``hlo_stats.HloStats``' fields, per device, and the collectives'
    records in the order they were dispatched."""

    flops: float = 0.0
    bytes: float = 0.0
    link_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_payload: dict = dataclasses.field(default_factory=dict)
    records: list = dataclasses.field(default_factory=list)   # the CollectiveRecords


class _StepCounter(CollectiveRecorder):
    """Collectives, matrix FLOPs and bytes of every local op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def seen(self, func, args, kwargs, out, rec) -> None:
        if in_sharding_propagation():
            return
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view and func.name().partition(".")[0] not in _NO_TRAFFIC:
            # an in-place op's output is one of its operands
            self.bytes += tensor_bytes((args, kwargs))
            self.bytes += 0 if func._schema.is_mutable else tensor_bytes(out)


def analyze_step(fn, *args, **kwargs) -> StepStats:
    """Run ``fn(*args, **kwargs)`` once and count this rank's work."""
    with _StepCounter() as counter:
        fn(*args, **kwargs)
    coll = collective_stats(counter.records)
    return StepStats(flops=float(counter.flops), bytes=float(counter.bytes),
                     link_bytes=coll.link_bytes, coll_counts=coll.counts,
                     coll_payload=coll.bytes_by_op, records=counter.records)
