"""Interoperation with the JAX package's artifacts."""
