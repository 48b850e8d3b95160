"""Plain PyTorch and NumPy reference of a ``tohr`` request: imports nothing of the program."""
