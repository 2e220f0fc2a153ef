"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); ``load_host`` does the same for a host C++ source with
g++. Libraries land in ``csrc/build/`` under a name that carries a hash of
the source and the flags, so an edited source is rebuilt and a second
process reuses the first one's build. Different sources may build at once
from several threads (``chip_smoke.py`` starts them together). Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per library: builds of different sources overlap
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building in this process, nvcc's stderr: ptxas report)
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with nvcc (once per source and flag set) and load it."""
    cmd = [_nvcc(), *ARCH_FLAGS, *BASE_FLAGS, *extra_flags, "-I", str(CSRC)]
    return _load(name, CSRC / f"{name}.cu", cmd)


def load_host(name: str, src: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """Compile a host C++ source with g++ into the same build directory and load it."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; cannot build the host libraries")
    return _load(name, src, [cxx, *flags])


def _load(name: str, src: Path, cmd: list[str]) -> ctypes.CDLL:
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        # The compiler's own path stays out of the hash, so a build is reused
        # wherever the toolkit lives.
        # The headers of csrc/ count too, so that a source is rebuilt when one it
        # includes changes.
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(cmd[1:]).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed to build {src.name}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_info[name] = (time.perf_counter() - t0, proc.stderr)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``RuntimeError`` where autograd is recording and any of
    ``tensors`` (a ctypes launch's inputs and weights; None entries are
    skipped) requires grad. Autograd cannot see a kernel launched through
    ctypes: the gradient of everything before it would be dropped without
    a word, while the layers after it trained. Reads host-side flags only,
    so it costs no device synchronisation."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input or weight of this CUDA kernel launch requires grad, and autograd cannot see the "
            "kernel, so every gradient before it would be lost; train through "
            "formula_vad_tpu_torch.train.nsnet2_train.apply (differentiable PyTorch ops), or run the forward "
            "under torch.no_grad() / torch.inference_mode()"
        )


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.fvad_error_string.restype = ctypes.c_char_p
        msg = lib.fvad_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
