"""launch modules of the PyTorch port."""
