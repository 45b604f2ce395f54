"""Camera rays for the port (no dataset loaders yet)."""
