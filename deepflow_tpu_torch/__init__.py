"""deepflow_tpu_torch — the PyTorch/CUDA port of deepflow_tpu for NVIDIA H100.

The JAX package `deepflow_tpu` stays the reference; this package holds
its own copies of what it needs and imports nothing from it (nor JAX).
Entry points run on the CUDA device unless given `device="cpu"`.

Ported so far: the L4/L7 1 s rollup main path (sketch-free,
cascade-free, full fold) with the segmented SUM/MAX reduce as a
hand-written CUDA kernel (kernels/segreduce.cu).
"""
