"""kernels modules of the PyTorch port."""
