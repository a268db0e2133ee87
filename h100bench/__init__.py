"""The benchmark of the PyTorch port on one H100 (see README.md)."""
