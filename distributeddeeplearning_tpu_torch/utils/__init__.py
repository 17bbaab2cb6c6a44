"""Host-side utilities of the port (``utils/`` of the reference)."""
