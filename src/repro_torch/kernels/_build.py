"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface (no PyTorch headers)
and is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library under ``build/kernels/`` at the repository root, at first use.
Library names carry a digest of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. All sources are
compiled at once, one ``nvcc`` process each. A failed build raises;
nothing falls back to the plain versions.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and imports every module.
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

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("hash_join", "seg_aggregate", "seg_topk", "flash_attention",
           "decode_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


@functools.cache
def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> float:
    """Compile every missing library, all ``nvcc`` processes started
    together. Returns the wall seconds spent (0.0 when all were built
    already). The compiler's report (registers, shared memory, spills:
    ``-Xptxas=-v``) lands beside each library as ``<name>-<digest>.log``.
    Raises RuntimeError with the compiler's output on a failed
    build."""
    todo = [n for n in SOURCES if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        # compile to a private name, then rename: a concurrent build of
        # the same digest never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            library_path(name).with_suffix(".log").write_text(out)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib_name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``lib_name``, built and
    loaded on first use, with its argument types declared (pointers
    and the stream as ``c_void_p`` so that 64-bit values pass whole)."""
    fn = _fns.get((lib_name, symbol))
    if fn is not None:
        return fn
    lib = _libs.get(lib_name)
    if lib is None:
        path = library_path(lib_name)
        if not path.is_file():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[lib_name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _fns[(lib_name, symbol)] = fn
    return fn


def check(lib_name: str, kernel: str, code: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = _libs[lib_name].repro_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")
