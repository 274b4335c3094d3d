"""data modules of the PyTorch port."""

from repro_torch.data import corpus_stats, genome, tokens  # noqa: F401
