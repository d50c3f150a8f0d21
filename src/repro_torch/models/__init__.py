"""Model zoo, PyTorch port: the dense decoder LM's serving path."""
