"""The port's frame-batch runner (`batch`) and slab geometry (`spatial`;
the spatial runner itself is not ported)."""
