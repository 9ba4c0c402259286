"""Tools of the port: the weight bridge from the JAX package's variables, the
offline scribble tooling, the raw-data conversion (``medio``,
``prepare_data``), and the quality study's summary (``study_summary``)."""
