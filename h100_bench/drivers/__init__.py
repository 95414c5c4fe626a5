"""Per-cell traffic loops, one module per kind of traffic."""
