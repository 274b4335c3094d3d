"""train modules of the PyTorch port."""
