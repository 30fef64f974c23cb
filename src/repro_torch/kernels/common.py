"""Device resolution and the build of the hand-written CUDA kernels.

Every entry point of the port runs on the GPU unless the caller asks for
the CPU (``device="cpu"``), which the tests do.  There is no silent
switch: asking for CUDA on a host without a card raises.

The kernels are CUDA C++ sources under ``kernels/*/csrc``, compiled on
first use by ``nvcc`` for ``sm_90a`` into shared libraries with a plain C
interface and loaded with :mod:`ctypes`.  Libraries go to
``src/repro_torch/_build`` (git-ignored), keyed by a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the build.
:func:`build` starts one ``nvcc`` per library, all at once, and waits for
all of them; a failed build raises with the compiler's output.

A kernel wrapper given ``meta`` tensors (shapes and dtypes, no data)
runs neither its kernel nor its plain version: it returns empty outputs
of the right shapes and reports its work through :func:`meta_kernel`
to the recorder :func:`meta_recorder` installs (``core.signatures``'
op walker), so a model traced on ``meta`` prices each kernel call as
one operation.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "as_float_tensor",
           "FLOAT_DTYPES", "FLOAT_IO_HEADER", "check_float_dtypes",
           "check_kernel_device",
           "check_tensor", "check_no_backward",
           "KernelLaunchError", "check_launch",
           "KernelLib", "build", "NVCC_FLAGS", "BUILD_DIR",
           "meta_kernel", "meta_recorder"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Where built libraries live (listed in .gitignore).
BUILD_DIR = os.path.join(_PKG, "_build")

#: ``-fmad=false``: no fused multiply-add contraction, so every product
#: and sum rounds on its own exactly as the plain PyTorch versions do.
#: ``-Xptxas=-v`` makes the build log report each kernel's registers,
#: shared memory and spills (kept in ``KernelLib.build_log``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


class KernelLaunchError(RuntimeError):
    """A kernel launch that ``cudaGetLastError`` reported as failed.

    The one device-side failure a resilient service retries (beside the
    faults its chaos plan injects), as the reference retries its
    runtime's device errors.  A failed build, a missing ``nvcc``
    or a card of another compute capability raise other errors and are
    never transient."""


def check_launch(fn: str, err: int) -> None:
    """Raise :class:`KernelLaunchError` unless the C entry point ``fn``
    returned 0 (its ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise KernelLaunchError(f"{fn} launch failed: CUDA error {err}")


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor, numpy array or sequence) as a contiguous ``dtype``
    tensor on ``device``: a copy of an array, a tensor that already is
    one as it is.  numpy has no bfloat16, so a bfloat16 tensor must come
    as a tensor; an array asked to become one raises."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    if dtype not in _NP:
        raise TypeError(
            f"as_tensor: numpy has no {dtype}; pass a {dtype} tensor "
            f"(e.g. torch.tensor(x).to({dtype}))")
    return torch.tensor(np.ascontiguousarray(a, dtype=_NP[dtype]),
                        device=device)


#: The input dtypes of the attention kernels (K9, K10).
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
#: Their shared load/store and head-dim dispatch header.
FLOAT_IO_HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "csrc", "float_io.cuh")


def check_float_dtypes(**tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of FLOAT_DTYPES that the named tensors share (an
    attention kernel's inputs); raises ValueError otherwise."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= set(FLOAT_DTYPES):
        raise ValueError(
            f"{', '.join(tensors)} must share one dtype of {FLOAT_DTYPES}; "
            f"got {', '.join(str(t.dtype) for t in tensors.values())}")
    return dtypes.pop()


def as_float_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device``: a tensor keeps its
    dtype (one of FLOAT_DTYPES for the attention kernels), anything else
    becomes float32."""
    return as_tensor(a, a.dtype if isinstance(a, torch.Tensor)
                     else torch.float32, device)


def check_kernel_device(t: torch.Tensor) -> None:
    """A hand kernel runs only on a Hopper card (compute capability
    9.x, the ``sm_90a`` build target)."""
    major, minor = torch.cuda.get_device_capability(t.device)
    if major != 9:
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a; device {t.device} "
            f"has compute capability {major}.{minor}")


def check_tensor(t: torch.Tensor, name: str, dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on
    ``device`` whose dtype is ``dtype`` (or one of a tuple of dtypes,
    e.g. ``(torch.float32, torch.bfloat16)``) — what a kernel's raw
    pointer arithmetic assumes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {'/'.join(map(str, dtypes))} "
            f"{tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_no_backward(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when a gradient is asked for (grad
    mode on, one of ``tensors`` requiring grad) from a CUDA kernel that
    has no backward kernel yet: on the card no plain version stands in."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} backward: no backward kernel on the card yet; train "
            f"this arch on the CPU (device='cpu')")


_NP = {torch.float32: np.float32, torch.int32: np.int32}

#: The recorders :func:`meta_recorder` installed, innermost last.
_META_RECORDERS: List[Callable[..., None]] = []


def meta_kernel(name: str, flops: float, inputs: Sequence[torch.Tensor],
                outputs: Sequence[torch.Tensor]) -> None:
    """Report one shape-only kernel call: ``name``, its ``flops`` and its
    bytes, every input read once and every output written once, with
    the tensors themselves, to the innermost recorder (none installed:
    nothing)."""
    if _META_RECORDERS:
        _META_RECORDERS[-1](name, float(flops), float(sum(
            t.numel() * t.element_size() for t in (*inputs, *outputs))),
            tuple(inputs), tuple(outputs))


@contextlib.contextmanager
def meta_recorder(record: Callable[..., None]) -> Iterator[None]:
    """Within the block, each kernel call on ``meta`` tensors calls
    ``record(name, flops, bytes, inputs, outputs)`` once."""
    _META_RECORDERS.append(record)
    try:
        yield
    finally:
        _META_RECORDERS.pop()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


class KernelLib:
    """One shared library built from one ``.cu`` source (plus the
    headers it includes), with the C functions' ``argtypes`` declared
    by the caller.  The library is built and loaded on the first
    :meth:`get`, never at import."""

    def __init__(self, name: str, source: str, headers: Sequence[str] = (),
                 signatures: Optional[Dict[str, Tuple[list, type]]] = None
                 ) -> None:
        self.name = name
        self.source = source
        self.headers = tuple(headers)
        self.signatures = dict(signatures or {})
        #: kernel launches made through this library; the wrapper adds
        #: one per launch, a caller resets it to 0 before a run it audits.
        self.launches = 0
        #: compiler output of this process's build (empty when the
        #: library was already built).
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source,) + self.headers:
            with open(f, "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _load(self) -> ctypes.CDLL:
        lib = ctypes.CDLL(self.path())
        for fn, (argtypes, restype) in self.signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        return lib

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
        return self._lib


def build(libs: Iterable[KernelLib]) -> None:
    """Build every library that is not built yet, one ``nvcc`` process
    per library, all started together; then load them all.  Raises
    ``RuntimeError`` with the compiler output of any build that fails."""
    libs = [lib for lib in libs if lib._lib is None]
    todo = [lib for lib in libs if not os.path.isfile(lib.path())]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for lib in todo:
            out = lib.path()
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, lib.source]
            procs.append((lib, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for lib, out, tmp, p in procs:
            log, _ = p.communicate()
            lib.build_log = log.decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"nvcc failed for {lib.source} "
                              f"(exit {p.returncode}):\n"
                              f"{lib.build_log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    for lib in libs:
        lib._lib = lib._load()
