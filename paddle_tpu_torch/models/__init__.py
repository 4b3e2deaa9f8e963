"""Model builders over the port's DSL."""
