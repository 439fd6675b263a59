"""Path -> basecall conversion (numpy copy)."""
