"""The plain reference of the benchmark's fleet step: plain PyTorch, a
frozen copy of the port's plain math (its CPU path), importing nothing of
the port."""
