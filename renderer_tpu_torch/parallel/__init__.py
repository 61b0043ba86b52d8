"""Multi-device rendering over torch.distributed (parallel/mesh.py)."""
