"""Output formats (numpy copy)."""
