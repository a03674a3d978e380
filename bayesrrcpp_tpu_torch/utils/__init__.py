"""Host-side utilities of the port (NumPy only)."""
