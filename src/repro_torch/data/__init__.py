"""The training data pipeline: a verbatim copy of `repro.data.pipeline`
(numpy only), pinned by tests/test_torch_substrate.py."""

from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: F401
