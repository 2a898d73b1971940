"""Gossip-based federated learning on the device: the stacked, mesh-sharded
and per-user reference engines, the barrier-free trainer, and the
scheduler-integrated runners (counterpart of ``repro.fl``)."""

from repro_torch.fl.async_gossip import AsyncGossipTrainer
from repro_torch.fl.cnn import (
    StackedCNN,
    cnn_accuracy,
    cnn_forward,
    cnn_loss,
    init_cnn_params,
)
from repro_torch.fl.gossip import (
    BACKENDS,
    GossipConfig,
    GossipTrainer,
    mixing_arrays,
    shard_edge_arrays,
)
from repro_torch.fl.pilot import ema_update, measure_task_work, stacked_task_work
from repro_torch.fl.runner import FLExperiment, run_fl, run_fl_async
from repro_torch.fl.simulator import SimEvent, round_time, timeline
from repro_torch.fl.staleness import STALENESS_KINDS, StalenessWeights

__all__ = [
    "AsyncGossipTrainer",
    "BACKENDS",
    "FLExperiment",
    "GossipConfig",
    "GossipTrainer",
    "STALENESS_KINDS",
    "SimEvent",
    "StackedCNN",
    "StalenessWeights",
    "cnn_accuracy",
    "cnn_forward",
    "cnn_loss",
    "ema_update",
    "init_cnn_params",
    "measure_task_work",
    "mixing_arrays",
    "round_time",
    "run_fl",
    "run_fl_async",
    "shard_edge_arrays",
    "stacked_task_work",
    "timeline",
]
