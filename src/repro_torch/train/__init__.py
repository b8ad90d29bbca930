"""Step builders of the port (serving steps; training comes later)."""
