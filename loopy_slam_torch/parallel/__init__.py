"""Multi-device execution of the port over torch.distributed: one process
per rank (parallel/mesh.py), ray data parallelism on a replicated map
(parallel/sharded.py) and the cell-sharded map with ring k-NN
(parallel/map_shard.py)."""
