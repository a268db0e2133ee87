"""Command-line tools for inspecting the port's CUDA kernels."""
