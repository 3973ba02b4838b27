"""Neural-net modules of the port (reference parameter names)."""
