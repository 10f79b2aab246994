"""Host graph state for the port: the graph store and its worlds registry,
the native (C++) store binding, wire messages, g2o I/O and synthetic
graphs."""
