"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``_build`` compiles ``csrc/*.cu`` with one ``nvcc`` call into one shared
library with a C interface, loaded through ``ctypes``. Each wrapper takes
its plain version for a CPU tensor and launches its kernel (or raises) for
a CUDA tensor, and counts its launches in a plain integer.
"""
