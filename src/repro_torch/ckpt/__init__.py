"""Checkpoints: one ``.npy`` per global leaf, the JAX package's layout."""
