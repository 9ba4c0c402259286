"""Tools of the port: the weight bridge from the JAX package's variables, and
the offline scribble tooling."""
