"""The plain reference the benchmark holds the program's answers against:
plain PyTorch on any device and dtype, built from the benchmark's own
inputs and configuration files, importing nothing of the program."""
