"""Synthetic data of the gossip-FL slice (numpy; see ``synthetic``)."""

from repro_torch.data.synthetic import ImageDataset, image_dataset, stack_shards

__all__ = ["ImageDataset", "image_dataset", "stack_shards"]
