"""PyTorch ops on u32 lanes (ops/u32.py) and the segmented-reduce kernel wrapper."""
