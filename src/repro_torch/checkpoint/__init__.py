"""Exchange of parameters with the JAX package's checkpoint layout."""
