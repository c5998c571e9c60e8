"""PyTorch + CUDA port of the FedARA serving path (reference: ``src/repro``).

The package mirrors the JAX package path for path — ``repro/X/y.py`` becomes
``repro_torch/X/y.py`` and each module names its reference.  It imports
``torch``, numpy and the standard library only: nothing of JAX and nothing
of ``repro``.  The three Pallas TPU kernels become hand-written CUDA C++
kernels for Hopper (``csrc/``), built with ``nvcc`` at first use.
"""
