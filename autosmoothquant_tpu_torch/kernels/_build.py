"""Build the port's CUDA sources at first CUDA use and load them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into ``_build/lib<name>-<hash>.so`` inside this package, wherever
it lies, where ``<hash>`` covers the source, the shared headers and the flags, so
a changed source rebuilds and an unchanged one is reused. The libraries have a
plain C interface and are loaded with ``ctypes``: pointers and the stream go
as ``c_void_p``, and every entry point returns ``cudaGetLastError()``.

Importing this module builds nothing; only :func:`function` (reached from a
wrapper given a CUDA tensor) or :func:`build_all` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("int8_gemm", "add_rmsnorm_quant", "flash_attn", "fp8_gemm", "int4_gemm",
           "add_layernorm_quant", "rmsnorm_quant", "decode_attn", "moe_router")
HEADERS = ("asq_common.cuh", "asq_gemv.cuh", "asq_tma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source,
# kept for whoever wants to print it (chip_smoke.py does)
ptxas_report: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ on first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *(CSRC / x for x in HEADERS)):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel, then load all of them."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                ptxas_report.setdefault(name, "(reused an earlier build)")
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            ptxas_report[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return dict(_libs)


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<lib>.cu`` (built on first use)
    with its ``argtypes`` declared and an int (cudaError_t) result."""
    key = (lib, name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(build_all([lib])[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(lib: str, rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        err = _libs[lib].asq_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({err(rc).decode(errors='replace')})")


def stream_ptr(tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def ptr(tensor) -> int:
    return tensor.data_ptr() if tensor is not None else None
