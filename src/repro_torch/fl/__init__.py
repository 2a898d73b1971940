"""Gossip-based federated learning on the device: the stacked, mesh-sharded
and per-user reference engines and the scheduler-integrated runner
(counterpart of ``repro.fl``)."""

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
from repro_torch.fl.runner import FLExperiment, run_fl
from repro_torch.fl.simulator import round_time

__all__ = [
    "BACKENDS",
    "FLExperiment",
    "GossipConfig",
    "GossipTrainer",
    "StackedCNN",
    "cnn_accuracy",
    "cnn_forward",
    "cnn_loss",
    "ema_update",
    "init_cnn_params",
    "measure_task_work",
    "mixing_arrays",
    "round_time",
    "run_fl",
    "shard_edge_arrays",
    "stacked_task_work",
]
