"""Host-side helpers (image I/O, the camera overlay)."""
