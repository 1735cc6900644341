"""Build, load and call the port's CUDA kernels.

The sources under ``kernels/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  Each source compiles in its own ``nvcc`` process, all
started together, then one link; the result lands in ``build/kernels/``
at the repository root, named by a hash of the sources and flags, so a
second process (or a second call) reuses it.  Nothing is built when this
module is imported: the first kernel launch builds.

Every C entry point launches on the stream it is given, allocates
nothing, does not synchronise, and returns ``cudaGetLastError()``;
``check`` raises on anything but ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: ``<repo>/build/kernels`` (this file is ``<repo>/src/repro_torch/kernels/``).
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

#: ``dlopen`` (the bf16 attention kernel takes the driver's tensor-map
#: encoder from libcuda at run time, so nothing links against libcuda)
LINK_LIBS = ["-ldl"]

#: storage dtype codes (``enum ReproDtype`` in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_fused_update": [_P, _P, _P, _P, _P, _LL, _F, _F, _F, _I, _I, _P],
    "repro_fused_update_batched": [_P, _P, _P, _P, _I, _P, _P, _LL, _F, _F,
                                   _I, _I, _P],
    "repro_fused_int8_ef": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "repro_fused_topk_ef": [_P, _P, _P, _P, _LL, _F, _I, _I, _P],
    "repro_rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "repro_residual_rmsnorm": [_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _I, _P],
    "repro_ssm_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process ran (``-Xptxas -v``:
#: registers, shared memory and spills per kernel); empty when the
#: library was already built.
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's kernels cannot be built")
    return found


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library,
    unless a library for these exact sources exists already."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="obj-"))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        tmp_so = work / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so)]
            + [str(obj) for _, obj, _ in procs] + LINK_LIBS,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
        build_log = "\n".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def function(name: str):
    """One C entry point of the loaded library: after the first load, no
    lock is taken (ctypes keeps the function on the library object)."""
    return getattr(_lib if _lib is not None else library(), name)


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{kernel}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return code


def stream(device: torch.device) -> int:
    """The current stream's handle on ``device`` (an int for ctypes)."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{kernel}: tensors must share one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
    return dev
