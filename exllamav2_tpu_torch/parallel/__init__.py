"""Multi-GPU serving over torch.distributed: the mesh and the placement of a
rank's shard (sharding.py), data-parallel replicas (dp_server.py) and a
launcher of local ranks (launch.py)."""
