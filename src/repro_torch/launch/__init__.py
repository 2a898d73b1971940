"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``.train``, the gossip-FL user mesh (``UserMesh``, ``FLSharding``,
``pad_edge_lists``), the LM's meshes (``launch.mesh``) and rules
(``launch.sharding.MeshRules``), and the dry run (``python -m
repro_torch.launch.dryrun``: ``launch.step_stats``, ``launch.collectives``)."""

from repro_torch.launch.sharding import FLSharding, UserMesh, pad_edge_lists

__all__ = ["FLSharding", "UserMesh", "pad_edge_lists"]
