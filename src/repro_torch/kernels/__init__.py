"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``csrc/`` (the CUDA source), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (the wrapper). A wrapper sends a CPU tensor
to the plain version and a CUDA tensor to the kernel, and raises on
anything the kernel does not take. Each wrapper and each plain version
counts its launches in a plain integer attribute, ``launches``.
"""
