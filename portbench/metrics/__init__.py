"""The per-layer metrics' readers, one file each, found by name."""
