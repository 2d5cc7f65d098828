from repro_torch.serve.engine import ServeEngine, sample_tokens  # noqa: F401
