"""Graph executor core: Argument, the layer registry, initializers and the
Network executor."""
