"""The port's hand-written CUDA kernels (csrc/) and their wrappers.

Submodules are imported by name; nothing is compiled until a wrapper is
called on a CUDA tensor (see _build.py).
"""
