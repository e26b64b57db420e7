"""Host-side helpers (image I/O)."""
