"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``.  PyTorch's
headers are never included, so a build takes seconds, not minutes.  The
libraries go to ``build/repro_torch/<hash>/`` at the repository root (a
directory ``.gitignore`` lists), keyed by a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`set_build_root` moves that root (``serving.enable_compile_cache``)
for the libraries not loaded yet.

The build happens on first use: the first :func:`load` builds every
source whose library is missing, all at once.  It raises when ``nvcc`` is
missing or a build fails.  :func:`launch` calls a kernel's C entry point
on PyTorch's current stream and raises on the CUDA error it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def set_build_root(root) -> pathlib.Path:
    """Build into, and load from, ``<root>/<hash>/`` from now on.  A
    library this process has loaded already stays in use."""
    global BUILD_ROOT
    BUILD_ROOT = pathlib.Path(root).resolve()
    return BUILD_ROOT


def find_nvcc() -> str:
    """Path of ``nvcc``; raises if the CUDA toolkit is not installed."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: building the repro_torch CUDA kernels needs the "
            "CUDA toolkit (nvcc on PATH or under /usr/local/cuda/bin)")
    return nvcc


def sources() -> Dict[str, pathlib.Path]:
    """Every kernel source, ``{name: csrc/<name>.cu}``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> pathlib.Path:
    """The directory this checkout's sources and flags build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    for path in sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build_missing(out: pathlib.Path) -> None:
    """Build every source whose library is missing, one ``nvcc`` for each,
    all started together; each writes a temporary file that is renamed
    into place only when its build succeeded."""
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in sources().items():
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = out / f"{name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=f,
                                    stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, lib, log))
    failed = []
    for name, proc, tmp, lib, log in jobs:
        rc = proc.wait()
        if rc != 0:
            failed.append(f"nvcc failed to build {name} (exit {rc}): "
                          f"{log.read_text()[-4000:]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if name not in sources():
            raise ValueError(f"no kernel source csrc/{name}.cu")
        out = build_dir()
        path = out / f"lib{name}.so"
        if not path.exists():
            _build_missing(out)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (ptxas register and spill report), or ''
    when the library was reused from an earlier build."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def launch(name: str, fn_name: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call ``fn_name`` of ``csrc/<name>.cu`` with ``args`` and the current
    stream of ``device``; raise if it returns a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
