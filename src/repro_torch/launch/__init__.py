"""Launchers: ``python -m repro_torch.launch.train`` (training with the
fault-tolerant loop and checkpoints) and ``python -m
repro_torch.launch.serve`` (the index service and LM serving), the
counterparts of ``repro/launch/{train,serve}.py``."""
