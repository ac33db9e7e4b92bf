"""mano of the PyTorch port."""
