"""The benchmark of the PyTorch and CUDA port (``conzic_torch``): see README.md."""
