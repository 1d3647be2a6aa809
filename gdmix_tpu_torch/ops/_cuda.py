"""Build and load the hand-written CUDA kernels of `gdmix_tpu_torch/csrc`.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, loaded through ctypes. Libraries go to
`build/gdmix_tpu_torch/` in the checkout, or to the directory that
GDMIX_TPU_COMPILE_CACHE names (the JAX package's variable for its
persistent compiled-code cache; tools/prewarm.py fills it), named by a hash
of their sources, and are built on first use inside the process that
launches them: never at import, so the modules import on machines without
nvcc or a card.

Every C entry point returns `cudaGetLastError()` right after its launch, and
`check` raises on anything but 0: a refused launch never runs, and a later
synchronize would not report it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = (os.environ.get("GDMIX_TPU_COMPILE_CACHE")
             or os.path.join(os.path.dirname(_PKG), "build", "gdmix_tpu_torch"))
GENCODE = "arch=compute_90a,code=sm_90a"

# seconds spent compiling each library in this process (0.0 when it was
# already built), and the ptxas register / shared-memory report
build_seconds: Dict[str, float] = {}
ptxas_report: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def library_names():
    """The name of every CUDA library of csrc/ (one a .cu source)."""
    return tuple(sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC)
                        if f.endswith(".cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _source_hash(src: str) -> str:
    h = hashlib.sha256(GENCODE.encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(src)}.so")


def _build(names) -> None:
    """Compile the missing libraries of `names`, one nvcc process for each
    source, all started together."""
    procs = {}
    for name in names:
        src, so = _paths(name)
        build_seconds.setdefault(name, 0.0)
        if name in procs or os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (src, so, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (src, so, tmp, t0, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        ptxas_report[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def ptxas_lines(report: str):
    """'<entry function>: <registers, spills>' for each kernel of one
    library's `ptxas -v` report."""
    out, entry, spill = [], "", ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"{entry}: {used}; {spill}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiled if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _build([name])
    lib = ctypes.CDLL(_paths(name)[1])
    lib.gdx_error_string.restype = ctypes.c_char_p
    lib.gdx_error_string.argtypes = [ctypes.c_int]
    _libs[name] = lib
    return lib


def load_all(names) -> None:
    """Build the libraries of `names` in parallel, then load each."""
    _build([n for n in names if n not in _libs])
    for name in names:
        load(name)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gdx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _capability(device: torch.device):
    return torch.cuda.get_device_capability(device)


def require_cuda(what: str, *tensors: torch.Tensor,
                 dtypes=(torch.float32,)) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of an accepted
    type on a Hopper card (the kernels are built for sm_90a only; a card's
    capability is read once)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    major, minor = _capability(tensors[0].device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"{what}: kernels are built for sm_90a; this card "
                           f"is sm_{major}{minor}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current stream of t's card, as the kernels take it (the raw
    handle: no Stream object is made per launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


@contextlib.contextmanager
def on_card(t: torch.Tensor):
    """The device guard of every launch: t's card is the thread's current
    device inside the block, which yields that card's current stream. The C
    entry points launch, set their shared-memory opt-in
    (cudaFuncSetAttribute) and read cudaGetDevice on the CURRENT device,
    so a tensor on a second card needs its card made current first."""
    with torch.cuda.device(t.device):
        yield stream_of(t)
