"""The harness: the cell's files found by name, the served window, the
comparison with the plain reference, and the traced run's readings."""
