"""Host-side helpers of the port (frame I/O, mask resizing)."""
