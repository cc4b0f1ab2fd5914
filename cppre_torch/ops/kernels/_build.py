"""Build and load the CUDA kernels: nvcc into plain-C shared libraries, ctypes.

Each source `cppre_torch/csrc/<name>.cu` compiles on its own into
`build/cppre_torch/lib<name>_<hash>.so` beside the package (a directory git
ignores), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

The hash covers the source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one is reused. `build()` starts one `nvcc`
per missing library, all at once, and waits for them. Nothing is built when
a module is imported: the first kernel launch builds what it needs. There
is no fallback: without `nvcc` or on a compile error, the launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "ptxas_report", "declare", "check",
           "on_cuda", "require", "stream_of"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cppre_torch"
SOURCES = ("stencil_kernels", "flat_kernels", "fno_block", "fno_block_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cppre_torch compiles its CUDA "
                       "kernels on first use and needs the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ptxas said (registers, shared memory, spills) when `name` was built."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> float:
    """Compile every library of `names` not built yet, one nvcc each, all
    started together. Returns the wall seconds spent; raises on any failure."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `cppre_torch/csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.cppre_error_string.argtypes = [ctypes.c_int]
        lib.cppre_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


_DECLARED: dict = {}


def declare(lib: ctypes.CDLL, fn: str, argtypes, restype=ctypes.c_int):
    """`lib.fn` with its ctypes signature, set on the first call (a function
    has one signature; later calls reuse it)."""
    f = _DECLARED.get((id(lib), fn))
    if f is None:
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _DECLARED[(id(lib), fn)] = f
    return f


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if an exported function returned a CUDA error code."""
    if rc != 0:
        msg = lib.cppre_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# ---- what every wrapper does around its launch -----------------------------

def on_cuda(t) -> bool:
    """The routing rule: False for a CPU tensor (take the plain version),
    True for a CUDA tensor (launch the kernel); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"cppre_torch kernels take CPU or CUDA tensors, got {t.device}")


def require(t, what: str, shape=None, dtype=None, device=None) -> None:
    """Check what the kernel assumes of a tensor: CUDA, dtype, shape, contiguity."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
