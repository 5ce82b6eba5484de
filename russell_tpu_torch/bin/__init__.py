"""Command-line drivers of russell_tpu_torch (``python -m
russell_tpu_torch.bin.<name>``)."""
