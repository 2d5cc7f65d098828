from repro_torch.kernels.line_solve.ops import line_solve  # noqa: F401
