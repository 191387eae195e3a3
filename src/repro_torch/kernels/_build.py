"""nvcc build of the port's CUDA sources, shared by every kernel.

Each kernel is one CUDA C++ file under ``csrc/`` with a plain C interface
(plus the headers ``csrc/*.cuh`` that the sources share).  ``nvcc``
compiles it at first use for ``sm_90a`` into a shared library in
``build/kernels/`` at the root of the checkout (ignored by git), named by
a hash of the source and the headers so that an edit is rebuilt;
``ctypes`` loads it and sets the C functions' signatures once.
``Library.start`` runs ``nvcc`` in the background, so that a caller can
build several kernels at once and then ``load`` each.
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
    """``csrc/<name>.cu`` built into ``build/kernels/lib<name>-<hash>.so``.

    ``signatures`` maps each C function the wrapper calls to its
    ``(argtypes, restype)``; they are set once, when the library loads
    (ctypes otherwise passes a pointer as a 32-bit int)."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.log = ""          # nvcc's output (ptxas registers / spills)
        self._proc = None
        self._tmp = None
        self._lib = None

    def path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
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
        lib = ctypes.CDLL(str(self.path()))
        sigs = {"repro_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
                **self.signatures}
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        self._lib = lib
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                               f"{err} ({msg})")
