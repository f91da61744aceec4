"""Slab geometry of the port (the spatial runner itself is not ported)."""
