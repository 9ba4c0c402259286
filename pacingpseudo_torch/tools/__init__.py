"""Tools of the port: the weight bridge from the JAX package's variables, the
offline scribble tooling, and the raw-data conversion (``medio``,
``prepare_data``)."""
