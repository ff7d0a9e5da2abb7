"""One nvcc loader for every hand-written kernel of this package.

Each kernel's wrapper declares a ``Library``: the name of its CUDA source
under ``csrc/``, the ``-D`` defines that carry the wrapper's geometry into
it, and the ctypes signatures of its plain C entry points. ``load`` builds
the source at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/repro_torch/`` at the repository root (git-ignored) and loads
it with ``ctypes``; ``load_all`` starts one nvcc per source, all at once,
and waits for them together. The file name carries a hash of the source and
the flags, so an edited source or changed geometry rebuilds. A failed build
raises; nothing falls back to a plain version.

Every source exports ``<name>_error_string(int)`` beside its launch entry
points, which return ``cudaGetLastError()`` of their launches: ``check``
raises on a non-zero value with the runtime's message.

``build_count()`` counts library builds (loads) in this process over all
libraries. Eager PyTorch traces nothing, so the dispatch executor's
``DispatchStats.retraces`` (a count of jitted-body traces in the JAX
package) counts these builds instead: one per library on its first CUDA
launch in a process, none after it, none on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes types of the entry points' arguments: pointers and the stream are
# c_void_p (a Python int passed as a plain int would be cut to 32 bits)
PTR, INT = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Library:
    """A CUDA source under ``csrc/`` and the C entry points it exports."""
    name: str                                     # csrc/<name>.cu
    defines: Tuple[str, ...] = ()                 # -DNAME=value
    entry_points: Tuple[Tuple[str, Tuple], ...] = ()   # (symbol, argtypes)

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def flags(self) -> Tuple[str, ...]:
        return NVCC_FLAGS + self.defines

    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:12]}.so"


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    log: str                 # nvcc's output (ptxas registers/smem), or ''
    library: Library

    def check(self, err: int) -> None:
        """Raise on a non-zero ``cudaError_t`` returned by a launch."""
        if err:
            msg = getattr(self.lib, f"{self.library.name}_error_string")(err)
            raise RuntimeError(f"{self.library.name}: launch failed: "
                               f"{msg.decode()}")


_LOCK = threading.Lock()
_BUILT: Dict[Library, Built] = {}
_BUILDS = 0


def build_count() -> int:
    """Kernel library builds in this process (0 until the first CUDA call)."""
    return _BUILDS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (needed to build the kernels of "
                       f"{CSRC} for sm_90a)")


def _bind(library: Library, path: Path, log: str) -> Built:
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in library.entry_points:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{library.name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return Built(lib, path, log, library)


def load_all(libraries: Sequence[Library]) -> List[Built]:
    """Build (one nvcc per missing library, all started together) and load
    ``libraries``; idempotent. Raises if any build fails."""
    global _BUILDS
    with _LOCK:
        todo = [lib for lib in dict.fromkeys(libraries) if lib not in _BUILT]
        procs: List[Tuple[Library, Path, Path, Optional[subprocess.Popen]]] \
            = []
        for library in todo:
            path = library.path()
            if path.exists():
                procs.append((library, path, path, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs.append((library, path, tmp, subprocess.Popen(
                [_nvcc(), *library.flags, "-o", str(tmp),
                 str(library.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for library, path, tmp, proc in procs:
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"{library.name}: nvcc failed "
                                  f"({proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, path)
            _BUILT[library] = _bind(library, path, log)
            _BUILDS += 1
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_BUILT[lib] for lib in libraries]


def load(library: Library) -> Built:
    """Build (if needed) and load one library; idempotent. Every launch
    calls this, so a loaded library is returned without taking the lock."""
    built = _BUILT.get(library)
    return built if built is not None else load_all([library])[0]
