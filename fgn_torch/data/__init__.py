"""Episode batches as torch tensors."""
