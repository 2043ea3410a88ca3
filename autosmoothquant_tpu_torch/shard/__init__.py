"""Parallel serving and evaluation on ``torch.distributed``: the mesh and its
process groups (``mesh.py``), the family sharding rules (``sharding.py``)
and the microbatched stage schedule (``pipeline.py``)."""
