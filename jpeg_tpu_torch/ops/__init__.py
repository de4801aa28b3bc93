"""Plain PyTorch stages of the encode chain (the kernels' reference math)."""
