"""Engine of the port: config, metrics, cache, coalescer, search."""
