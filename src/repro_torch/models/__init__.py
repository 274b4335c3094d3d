"""models modules of the PyTorch port."""
