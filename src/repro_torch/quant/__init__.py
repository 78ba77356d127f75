"""Fixed-point grids, LUT nonlinearities and the int8 / int4 exporter."""
