"""Parallel serving on ``torch.distributed``: the mesh and its process
groups (``mesh.py``) and the family sharding rules (``sharding.py``)."""
