"""Synthetic data (numpy; see ``synthetic``): the LM token stream and the
gossip-FL images."""

from repro_torch.data.synthetic import ImageDataset, LMStream, image_dataset, stack_shards

__all__ = ["ImageDataset", "LMStream", "image_dataset", "stack_shards"]
