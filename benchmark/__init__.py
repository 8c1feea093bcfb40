"""The benchmark of the PyTorch/CUDA port: ``python -m benchmark.run``."""
