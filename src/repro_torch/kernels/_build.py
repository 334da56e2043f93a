"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so``, where the hash covers the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. :func:`build`
starts one ``nvcc`` a source, all at once, and waits for every one of
them. Nothing here runs at import time: the CPU
tests import the kernel modules on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("paged_decode_attention", "flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}    # loaded libraries, by source name
# replicas stepping on several threads may meet a kernel first at once:
# one builds and loads it, the others wait
_LIBS_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library for ``<csrc>/<name>.cu``, the headers beside it
    and these flags lives."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) of the last build of ``name``."""
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together; returns the library paths. Raises with the
    compiler's output if any build fails (after all of them have ended)."""
    names = list(names)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        output, _ = proc.communicate()
        out.with_suffix(".log").write_text(output)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
        else:
            os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Its
    ``<name>_error_string`` entry point is bound here; the caller binds
    the kernel's own entry point."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from a kernel's entry point."""
    if rc:
        msg = getattr(_LIBS[name], f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
