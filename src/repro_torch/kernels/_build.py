"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source becomes its own shared library with a plain C
interface (``extern "C"`` entry points that launch on the stream they are
given and return the ``cudaError_t`` of the launch).  The libraries go into
``build/repro_torch/<hash>/`` at the root of the checkout, where ``<hash>``
covers every source, header and flag, so an edited kernel is rebuilt and an
unchanged one never is.  The sources compile at first use, all at once (one
``nvcc`` process per source, started together); nothing is compiled when a
module is imported, so the package imports on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm", "gemv", "decode_attention", "prefill_attention",
           "mx_gemv", "fused_adamw", "dotp", "axpy", "qgemv",
           "flash_attention", "rwkv6", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def build_dir() -> Path:
    """``build/repro_torch/<hash>`` under the checkout, the hash covering
    every source, header and flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return _repo_root() / "build" / "repro_torch" / h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are compiled from csrc/ at first use")
    return found


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every missing library in parallel; return the build log
    (per source: seconds until its nvcc was collected, and nvcc's output
    with the ptxas register report), empty when nothing was missing."""
    with _LOCK:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        todo = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
        if not todo:
            return {}
        exe = nvcc()
        procs = {}
        t0 = time.perf_counter()
        for s in todo:
            tmp = out / f"lib{s}.so.{os.getpid()}.tmp"
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
            procs[s] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        log, failed = {}, []
        for s, (tmp, p) in procs.items():
            text, _ = p.communicate()
            log[s] = {"seconds": time.perf_counter() - t0, "nvcc": text}
            if p.returncode != 0:
                failed.append(f"--- {s}.cu (exit {p.returncode}) ---\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out / f"lib{s}.so")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return log


def library(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use) with
    the ``argtypes`` of its entry points set; every entry point returns a
    ``cudaError_t`` (``ctypes.c_int``)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, types in argtypes.items():
            f = getattr(lib, fn)
            f.argtypes = types
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    """Raise on a refused launch (the kernel never ran)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device``."""
    import torch
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


_RESIDENT: Dict[tuple, int] = {}


def resident(device, occupancy, *args) -> int:
    """Blocks of a kernel that the card holds at once: ``occupancy(*args)``
    (a library entry point that returns the blocks one SM holds) times the
    SMs, asked once per device, entry point and arguments.  An entry point
    returns 0 for a parameter set its kernel cannot launch: that raises,
    and is not kept."""
    import torch
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, occupancy.__name__, args)
    if key not in _RESIDENT:
        per_sm = occupancy(*args)
        if per_sm <= 0:
            raise RuntimeError(f"{occupancy.__name__}{args}: the kernel "
                               f"cannot launch with these parameters")
        _RESIDENT[key] = per_sm * _sm_count(index)
    return _RESIDENT[key]


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
