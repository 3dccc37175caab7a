"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles on its own, by hand, into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

and is loaded with ``ctypes``.  The library name carries a hash of the
source, the headers under ``csrc`` it includes (``hopper.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused; builds land in ``build/`` at the repository root on first use.
Nothing is built at import time.  A missing ``nvcc`` or a failed compile or
load raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("gbt_hist", "tree_predict", "decide_split", "flash_attention",
           "ssm_scan", "int8_matmul", "fleet_scan", "slstm_scan",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled from src/repro_torch/csrc at "
        "first use and need the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """The files a build of kernel ``name`` reads from ``csrc``:
    ``<name>.cu`` first, then each header it includes with quotes,
    directly or through another header, once each."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in out:
            out.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return out


def library_path(name: str) -> Path:
    """Where the build of kernel ``name`` lives for its current sources
    (the ``.cu`` and the headers it includes) and flags."""
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in sources(name))
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> dict[str, str]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns each compiled
    kernel's compiler output (``-Xptxas -v``: registers, shared memory,
    spills); raises naming every kernel that failed."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                                   suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: "
                           + "\n".join(failed))
    return logs


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s built library (``cuobjdump
    --dump-sass``, the toolkit's, beside ``nvcc``)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "--dump-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, as the C launchers take it."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
