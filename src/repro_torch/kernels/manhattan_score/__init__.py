from repro_torch.kernels.manhattan_score.ops import manhattan_score  # noqa: F401
