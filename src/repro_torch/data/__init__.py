"""data modules of the PyTorch port."""
