"""The L4 rollup benchmark of the PyTorch/CUDA port (see run.py)."""
