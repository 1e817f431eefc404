"""Hand-written CUDA kernels for Hopper (sm_90a): the paper's hot path.

Each kernel lives in its own subpackage, mirroring ``repro.kernels``:

  * ``<name>.py`` — the launch wrapper: checks its arguments, launches the
    CUDA kernel of ``csrc/<name>.cu`` on the current stream through ctypes,
    and counts its launches in ``<wrapper>.launches``.
  * ``ops.py``    — the public op: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.
  * ``ref.py``    — the plain PyTorch version of the same function.

The kernels are built by ``_build`` with nvcc at first launch, never at
import, so this package imports on a machine without a compiler.
"""
