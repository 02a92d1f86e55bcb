"""Shared runtime pieces of the port's hand-written CUDA kernels.

* ``NO_WINDOW`` — the "no sliding window" sentinel shared by every masking
  path (both kernels and the plain PyTorch versions): int32-safe and larger
  than any position, so ``diff < NO_WINDOW`` never masks.
* ``BACKENDS`` / ``resolve_backend`` / ``use_kernel`` — the compute
  backend threaded from ``serving.GeoServingSystem`` down to the attention
  and scan calls.  ``"kernel"`` (the default) sends a CUDA tensor to the
  hand-written kernel and a CPU tensor to the kernel's plain PyTorch
  version; ``"plain"`` runs the plain version on any device (the oracle a
  kernel is held against on the card).
  There is no fallback: on a CUDA tensor under ``"kernel"`` a wrapper
  launches its kernel or raises.
* ``refuse_grad`` — the kernels have no backward (the reference's Pallas
  kernels have none either; it trains on its XLA path, the port on the
  plain versions).  A kernel's output is written through ``ctypes`` into a
  fresh tensor with no ``grad_fn``, so a wrapper raises rather than launch
  while autograd records a call on an input that requires grad: the
  gradients of its inputs would be dropped without an error.
* ``count_meta_calls`` — a step run on meta tensors (no data, no device)
  inside this block sends its attention and scans to the kernel wrappers
  (K1 and its partials and merge, K2, K3, K4), each of which adds the
  call's ``cost``, allocates what its launch would (outputs and split
  scratch) and returns empty outputs: the count of a step's work is then
  the same wherever the step runs (``BlockServer.decode_step_cost``, the
  dry run ``launch.dryrun``).
* ``load_library`` / ``build_all`` — build ``csrc/<name>.cu`` with ``nvcc``
  for ``sm_90a`` into a shared library with a plain C interface, and load it
  with ``ctypes``.  The build happens at first use, never at import, into
  ``<repo>/build/kernels`` (``REPRO_TORCH_BUILD_DIR`` overrides it); the file
  name carries a hash of the sources and flags, so a stale library is never
  loaded.  ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.launch.costs import CostSummary

NO_WINDOW = 1 << 30

BACKENDS = ("kernel", "plain")

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("decode_attention", "flash_attention",
                  "flash_attention_sm90", "wkv6", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of builds done by this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def resolve_backend(backend: str) -> str:
    """Validate an attention-backend name; ``ValueError`` names the options."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown attention backend {backend!r}; supported backends: "
            + ", ".join(BACKENDS))
    return backend


def use_kernel(backend: str, x) -> bool:
    """Device dispatch: a hand-written kernel serves a CUDA tensor under
    ``backend="kernel"``; a CPU tensor, or ``backend="plain"``, takes the
    plain path.  A CUDA call a kernel cannot serve raises in the kernel
    wrapper — it never drops to the plain path.  A meta tensor goes to the
    wrapper too, which counts it inside ``count_meta_calls`` and raises
    outside it."""
    return resolve_backend(backend) == "kernel" and (x.is_cuda or x.is_meta)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when autograd is recording and any of
    ``tensors`` (None entries skipped) requires grad: kernel ``name`` has
    no backward.  Serving runs on leaves that require no grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward, and an input "
            "requires grad; differentiate through the plain versions "
            "(backend=\"plain\", as models.train_loss does) or call the "
            "kernel under torch.no_grad()")


class MetaCalls:
    """The kernel calls a step makes on meta tensors: their summed cost
    (a ``launch.costs.CostSummary``), K1's counted with every row at
    ``pos`` and, where a call masks by encoder length, at ``kv_len``; K2
    takes its ``q_start`` and window from the call's own arguments."""

    def __init__(self, pos: int, kv_len: int):
        self.pos, self.kv_len = int(pos), int(kv_len)
        self.cost = CostSummary()


_META_CALLS: contextvars.ContextVar = contextvars.ContextVar(
    "meta_calls", default=None)


@contextlib.contextmanager
def count_meta_calls(pos: int, kv_len: int = 0):
    """Count the kernel calls made on meta tensors inside the block (see
    ``MetaCalls``); yields the ``MetaCalls``."""
    calls = MetaCalls(pos, kv_len)
    token = _META_CALLS.set(calls)
    try:
        yield calls
    finally:
        _META_CALLS.reset(token)


def meta_calls() -> Optional[MetaCalls]:
    """The active ``MetaCalls``, or None outside ``count_meta_calls``."""
    return _META_CALLS.get()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from src/repro_torch/kernels/csrc at "
        "first use and need the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path,
                                               float]]:
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build_all(names=KERNEL_SOURCES) -> None:
    """Build every named kernel library that is not built yet, one ``nvcc``
    per source, all started together."""
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def require_ints(**sizes) -> None:
    """Raise TypeError unless every size is a Python int: a launch plan is
    a function of host-known sizes, never of tensor values (reading one
    would sync the host)."""
    for name, v in sizes.items():
        if type(v) is not int:
            raise TypeError(f"{name} must be a Python int, got "
                            f"{type(v).__name__}")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch wrapper returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
