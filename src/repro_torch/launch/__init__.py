"""Launchers of the port: ``python -m repro_torch.launch.serve``, and the
gossip-FL user mesh (``UserMesh``, ``FLSharding``, ``pad_edge_lists``)."""

from repro_torch.launch.sharding import FLSharding, UserMesh, pad_edge_lists

__all__ = ["FLSharding", "UserMesh", "pad_edge_lists"]
