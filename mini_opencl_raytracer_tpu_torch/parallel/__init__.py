"""Multi-device paths on ``torch.distributed``: process groups, device
meshes, collectives, sharded rendering and training."""
