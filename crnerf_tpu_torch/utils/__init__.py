"""Weight bridge and small helpers."""
