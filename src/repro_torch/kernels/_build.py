"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The library is
built at first use, from the sources in this package only, into
``<repo>/build/kernels/`` under a name that carries a hash of the sources and
flags, so an edited source is rebuilt.  A failed build raises with nvcc's
stderr; nothing falls back to the plain versions.

Building, loading and counting launches are safe from several threads (the
lanes of a sharded scan): a module lock serializes builds and loads, so a
library is compiled once per process, and each nvcc writes a temporary file
named by process and thread before it is renamed into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("epsma", "epsmb", "epsmc", "multipattern", "megascan", "approx", "acscan",
           "baselines")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[tuple, ctypes._CFuncPtr] = {}
# Serializes build, load and function across threads; it is reentrant
# because load builds and function loads.
_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A C launcher returned a CUDA error: a failure of the card, which no
    retry of the fault fabric treats as a source error."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library that is not built yet, one nvcc per source, all
    running at once.  Returns the library path of each name."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: Iterable[str]) -> Dict[str, Path]:
    targets = {name: _target(name) for name in names}
    todo = {name: so for name, so in targets.items() if not so.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


PTR = ctypes.c_void_p
I64 = ctypes.c_longlong


def check_u8(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 1-D uint8 tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on the same CUDA device")
        if t.dtype != torch.uint8 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous 1-D uint8 tensors")


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``fn_name`` of library ``lib_name``, typed once and
    cached per (library, name): a launch sets no ``argtypes`` again."""
    fn = _FUNCTIONS.get((lib_name, fn_name))
    if fn is None:
        with _LOCK:
            fn = _FUNCTIONS.get((lib_name, fn_name))
            if fn is None:
                fn = getattr(load(lib_name), fn_name)
                fn.argtypes = [*argtypes, PTR]  # the stream comes last
                fn.restype = ctypes.c_int
                _FUNCTIONS[lib_name, fn_name] = fn
    return fn


def count_launch(wrapper) -> None:
    """Add one to a wrapper's ``launches`` counter (read-modify-write under
    a lock: lanes launch from several threads)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(lib_name: str, rc: int) -> None:
    """Raise if a C launcher returned a nonzero cudaGetLastError() code."""
    if rc != 0:
        lib = load(lib_name)
        lib.epsm_error_string.restype = ctypes.c_char_p
        msg = lib.epsm_error_string(ctypes.c_int(rc)).decode()
        raise KernelLaunchError(f"{lib_name} kernel launch failed: {msg} (cudaError {rc})")


def on_device(t: torch.Tensor, kernel, plain):
    """The kernel's wrapper for a CUDA tensor, its plain version for a CPU one."""
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise RuntimeError(f"no kernel for device {t.device}")


def check_pair(name: str, text: torch.Tensor, pattern: torch.Tensor) -> None:
    """Raise unless text and pattern are 1-D uint8 tensors on one device."""
    for t in (text, pattern):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 or t.ndim != 1:
            raise ValueError(f"{name}: text and pattern must be 1-D uint8 tensors")
    if text.device != pattern.device:
        raise ValueError(f"{name}: text and pattern must be on one device")
