"""The port's network configuration: builders, layers, vertices."""
