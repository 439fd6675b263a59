"""Plain references of the configurations' families (PyTorch and numpy;
nothing of the program)."""
