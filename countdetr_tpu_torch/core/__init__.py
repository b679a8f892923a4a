"""Process topology of a run (one process on one card)."""
