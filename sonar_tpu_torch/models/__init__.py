"""Model definitions of the PyTorch port."""
