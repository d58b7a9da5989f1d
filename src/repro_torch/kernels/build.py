"""Build the CUDA sources in csrc/ with nvcc and load them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for sm_90a only
and without --use_fast_math: the kernels use precise logf/cosf/sqrtf. The
library name carries a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded. Builds land in
build/repro_torch_kernels/ at the checkout root (listed in .gitignore).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("seeded_axpy", "flash_attention", "perturbed_matmul", "ssd_scan",
           "rglru_scan")

#: the suffix of a C entry point's instance for each dtype the kernels
#: take (`seeded_axpy_f32`, `flash_attention_bf16`, ...)
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers are part of every source's build
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library in `names`, one nvcc per source, all
    started together. Returns the wall seconds spent; raises with nvcc's
    output if any build fails."""
    import time
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)      # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def entries(name: str, prefix: str, argtypes: Tuple) -> Dict:
    """{dtype: entry `<prefix>_<SUFFIX[dtype]>`} of csrc/<name>.cu's
    library, each given `argtypes` and an int status once a library."""
    return _entries(load(name), prefix, argtypes)


@functools.lru_cache(maxsize=None)
def _entries(lib, prefix: str, argtypes: Tuple) -> Dict:
    out = {}
    for dtype, suffix in SUFFIX.items():
        fn = getattr(lib, f"{prefix}_{suffix}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
