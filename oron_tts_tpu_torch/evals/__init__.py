"""Quality evaluations of the PyTorch port (the tone-code alignment protocol)."""
