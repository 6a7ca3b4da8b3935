"""The plain reference of the benchmark: float32 PyTorch (TF32 off) and
numpy, importing nothing of the program under test."""
