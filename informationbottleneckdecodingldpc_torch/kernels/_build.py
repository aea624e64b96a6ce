"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. At first CUDA use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library and loaded
with ``ctypes``. Libraries go to ``build/kernels/`` at the checkout's root
(listed in ``.gitignore``), in a directory keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is reused. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def load_library(name: str) -> tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu``.

    Returns the library and a record of the build: ``seconds`` spent
    compiling (0 when reused), ``path`` of the library and ``log``, the
    compiler's register and shared-memory report."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # Compile to a private name and rename, so concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    return lib, {"seconds": seconds, "path": str(lib_path), "log": log}


class CLibrary:
    """A library of ``csrc/`` with a plain C interface: ``functions`` maps
    each C function to its argument types (each returns an int, a
    cudaError_t for a launcher), and ``<name>_error_string`` turns an error
    into CUDA's message."""

    def __init__(self, name: str, functions: dict[str, list]):
        lib, self.build = load_library(name)
        self.name = name
        self._functions = {}
        for fn_name, argtypes in functions.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._functions[fn_name] = fn
        self._error_string = getattr(lib, f"{name}_error_string")
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p

    def value(self, fn_name: str, *args) -> int:
        """The int a C function returns."""
        return self._functions[fn_name](*args)

    def launch(self, fn_name: str, *args) -> None:
        """Call a launcher; raises with CUDA's message if it was refused."""
        err = self._functions[fn_name](*args)
        if err != 0:
            raise RuntimeError(
                f"{fn_name} launch failed: " + self._error_string(err).decode()
            )


class KernelLibrary(CLibrary):
    """The C interface of a decoder library of ``csrc/``: ``<name>_decode``
    returning a cudaError_t, ``<name>_error_string``, any other C functions
    in ``functions`` (as :class:`CLibrary`'s), and per constant of the
    wrapper (``max_degree`` and any in ``constants``) a function
    ``<name>_<constant>`` returning the source's value, which must equal it."""

    def __init__(self, name: str, decode_argtypes: list, max_degree: int,
                 functions: dict[str, list] | None = None, **constants: int):
        constants = {"max_degree": max_degree, **constants}
        super().__init__(
            name,
            {f"{name}_decode": decode_argtypes, **(functions or {}),
             **{f"{name}_{c}": [] for c in constants}},
        )
        for c, want in constants.items():
            got = self.value(f"{name}_{c}")
            if got != want:
                raise RuntimeError(f"csrc/{name}.cu's {c} is {got}, the wrapper's {want}")

    def decode(self, *args) -> None:
        """Launch the decode; raises with CUDA's message if it was refused."""
        self.launch(f"{self.name}_decode", *args)
