"""Host-side signal reading and preprocessing (numpy copies)."""
