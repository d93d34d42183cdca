"""Weight conversion from the JAX package and card-side initialization."""
