"""optim package of the PyTorch port."""
