"""Builds the CUDA sources under ``kernels/csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` (with the shared ``csrc/*.cuh`` headers it includes) into its
own shared library, loaded with :mod:`ctypes`: no PyTorch headers and no
pybind11 bindings to compile.  Libraries go to ``kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source, the headers
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  :func:`build` compiles several sources in parallel, one ``nvcc``
each.  A failed build raises; nothing falls back.  A library's first load
is a ``kernel.load`` span of the current tracer (args ``library`` and
``compiled``: whether ``nvcc`` ran).

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

from repro_torch.obs.trace import current_tracer

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("hermitian", "batch_solve", "sgd_update", "herm_hbm_accum", "sq_err")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    candidates = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] \
        if os.environ.get("CUDA_HOME") else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current source
    and the shared headers (``csrc/*.cuh``) it may include."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said (registers, shared memory, spills)
    when the current library of ``name`` was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(names: Iterable[str] = KERNELS) -> list[str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together.  Returns the names actually compiled."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        with current_tracer().span("kernel.load", cat="build", library=name,
                                   compiled=not library_path(name).is_file()):
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def loaded() -> tuple[str, ...]:
    """Names of the libraries loaded in this process."""
    return tuple(_LIBS)
