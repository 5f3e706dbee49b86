from repro_torch.data.pipeline import DataState, SyntheticLM  # noqa: F401
