"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers, and the plain
PyTorch versions they are held against (``ref``).

Importing this package builds nothing: a kernel is compiled by ``nvcc`` the
first time its wrapper is called on a CUDA tensor (see ``_build``).
"""
