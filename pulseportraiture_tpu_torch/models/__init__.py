"""Template evaluation (host numpy)."""
