from repro_torch.kernels.slstm_scan.ops import slstm_scan  # noqa: F401
