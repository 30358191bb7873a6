"""Model layers, attention and LM parameters of the port."""
