"""The PyTorch and CUDA port's benchmark (see README.md)."""
