"""Search layer: per-beam executor, candidate sifting, reports."""
