"""The plain reference the benchmark judges the program's answers by:
plain PyTorch and NumPy, importing nothing of the program, taking only the
inputs the harness made."""
