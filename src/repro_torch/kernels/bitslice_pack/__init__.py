from repro_torch.kernels.bitslice_pack.ops import bitslice_pack  # noqa: F401
