"""Per-plugin filter/score/normalize on torch tensors, batched over pods."""
