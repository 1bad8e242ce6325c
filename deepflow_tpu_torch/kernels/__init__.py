"""Hand-written CUDA kernels (*.cu) and build.py, which compiles and loads them."""
