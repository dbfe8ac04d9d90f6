"""Per-frame stereo math as plain PyTorch tensor functions."""
