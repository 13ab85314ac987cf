"""Data parallelism: the process group and its helpers (distributed.py),
DDP for training and inference replicas (mesh.py)."""
