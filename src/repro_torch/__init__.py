"""PyTorch / CUDA port of the EPSM packed string matcher, for NVIDIA Hopper.

The twin of the JAX package ``repro``, which stays the reference.  It imports
torch and numpy only.  Ported so far: ``core.packing``, ``core.epsm``
(find / count / positions through the EPSMa/b/c CUDA kernels) and
``data.corpus``.
"""
