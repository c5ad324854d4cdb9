"""Model zoo (the dense decoder family so far)."""
