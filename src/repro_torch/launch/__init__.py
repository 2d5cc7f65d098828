"""Command-line front doors of the port: ``python -m
repro_torch.launch.serve`` (batched generation) and ``python -m
repro_torch.launch.train`` (a checkpointed training run), the
reference's ``repro.launch.serve`` and ``repro.launch.train``."""
