"""Training steps of the port (single device; the multi-GPU mesh is a
later slice)."""
