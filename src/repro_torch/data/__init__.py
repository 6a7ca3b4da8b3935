"""data package of the PyTorch port."""
