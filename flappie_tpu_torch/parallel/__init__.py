"""Chunk planning for long reads (numpy copy)."""
