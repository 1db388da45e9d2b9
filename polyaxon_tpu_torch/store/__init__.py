"""Storage helpers of the port (own copies: nothing of the JAX package)."""
