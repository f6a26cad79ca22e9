"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel's ``csrc/*.cu`` compiles for Hopper (``sm_90a``) into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, on first use. Headers shared by several kernels
live in ``csrc/`` beside this file, which nvcc searches after the
source's own directory. The file name carries a hash of the source, of
the headers beside it, of every header it includes (from either place)
and of the flags, so an edited source or header builds anew. A missing
``nvcc`` or a failed build raises: nothing falls back to the plain
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
SHARED_CSRC = "csrc"   # headers shared by several kernels, under KERNELS_DIR
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

# name -> source, relative to this directory
SOURCES = {
    "flash_fwd": "flash_attention/csrc/flash_fwd.cu",
    "flash_bwd": "flash_attention/csrc/flash_bwd.cu",
    "decode": "decode_attention/csrc/decode.cu",
    "ssd_scan": "ssm_scan/csrc/ssd_scan.cu",
    "rwkv6_scan": "rwkv6_scan/csrc/rwkv6_scan.cu",
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (with ptxas's registers, spills and warnings) for
# each library this process built; it is also kept beside the library
LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and DEFAULT_NVCC.exists():
        nvcc = str(DEFAULT_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _included(src: Path) -> list:
    """The headers that ``src`` includes with quotes, and those they
    include, each found as nvcc finds it: beside the including file, else
    in the shared ``csrc/``. One that is in neither place is left out."""
    found, todo = [], [src]
    while todo:
        at = todo.pop()
        for name in _INCLUDE.findall(at.read_text()):
            for path in (at.parent / name, KERNELS_DIR / SHARED_CSRC / name):
                if path.is_file():
                    if path not in found:
                        found.append(path)
                        todo.append(path)
                    break
    return found


def _target(name: str) -> Path:
    """The library's path: its name carries a hash of the source, of the
    headers beside it (``*.cuh`` in its ``csrc/``), of the headers it
    includes and of the flags."""
    src = KERNELS_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    headers = sorted(set(src.parent.glob("*.cuh")) | set(_included(src)))
    for header in headers:
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc into a temporary file; returns (process, tmp, target)."""
    target = _target(name)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(KERNELS_DIR / SHARED_CSRC),
           "-o", str(tmp), str(KERNELS_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel, one nvcc each) and load the named kernels."""
    names = list(names)
    with _lock:
        todo = [n for n in names if n not in _loaded
                and not _target(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            jobs = {n: _start(n, nvcc) for n in todo}
            errors = []
            for n, (proc, tmp, target) in jobs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {SOURCES[n]} "
                                  f"(exit {proc.returncode}):\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    target.with_suffix(".log").write_text(out)
                    os.replace(tmp, target)
                    LOGS[n] = out
            if errors:
                raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _loaded:
                _loaded[n] = ctypes.CDLL(str(_target(n)))
        return {n: _loaded[n] for n in names}


def log(name: str) -> str:
    """nvcc's output for the library of ``name`` as it stands now: this
    process's build, else the log kept beside a cached library, else ""."""
    if name in LOGS:
        return LOGS[name]
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _loaded.get(name)
    return lib if lib is not None else build([name])[name]


# What the compiled kernels are instantiated for (see the csrc files).
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
HEAD_DIMS = (16, 32, 64, 112, 128)


def dtype_code(t) -> int:
    """The kernels' code for a tensor's dtype; raises for any other."""
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {t.dtype}")
    return DTYPE_CODES[name]


def check_cuda_status(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
