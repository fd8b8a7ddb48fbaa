"""Model zoo of the port: configs, parameter specs, layers, attention and
the serving forward (prefill + paged decode)."""
