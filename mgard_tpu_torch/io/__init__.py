"""Container format and state carried across from the JAX package."""
