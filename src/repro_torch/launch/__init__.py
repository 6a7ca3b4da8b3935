"""launch package of the PyTorch port."""
