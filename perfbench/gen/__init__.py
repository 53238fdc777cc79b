"""Graph generators, one module a generator named by a configuration."""
