"""Per-stage ops of the port (one module per reference ops module)."""
