"""nvcc build of the port's CUDA sources, shared by every kernel.

Each kernel is one CUDA C++ file under ``csrc/`` with a plain C interface.
``nvcc`` compiles it at first use for ``sm_90a`` into a shared library in
``build/kernels/`` at the root of the checkout (ignored by git), named by
a hash of the source so that an edited source is rebuilt; ``ctypes``
loads it.  ``Library.start`` runs ``nvcc`` in the background, so that a
caller can build several kernels at once and then ``load`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the port's CUDA kernels cannot be built")


class Library:
    """``csrc/<name>.cu`` built into ``build/kernels/lib<name>-<hash>.so``."""

    def __init__(self, name: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.log = ""          # nvcc's output (ptxas registers / spills)
        self._proc = None
        self._tmp = None
        self._lib = None

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start(self) -> None:
        """Start nvcc in the background unless the library is built,
        loaded, or already being built."""
        if self._lib is not None or self._proc is not None \
                or self.path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path().with_name(
            f"{self.path().name}.{os.getpid()}.tmp")
        self._proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Wait for the build (starting it if needed) and load the library;
        raises with nvcc's output if the build fails."""
        if self._lib is not None:
            return self._lib
        self.start()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            self.log, rc, self._proc = out, self._proc.returncode, None
            if rc != 0:
                raise RuntimeError(f"nvcc failed to build "
                                   f"{self.source.name}:\n{self.log}")
            os.replace(self._tmp, self.path())
        self._lib = ctypes.CDLL(str(self.path()))
        self._lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        self._lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                               f"{err} ({msg})")
