"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles, with nvcc for ``sm_90a``, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``cfk_tpu_torch/_build/``.  The first kernel call of a
process builds every library that is missing — one nvcc per source, all
started at once — and later calls reuse them.  A library's file name carries
a hash of its sources and flags, so an edited source is rebuilt.  Wrappers
pass tensor pointers and PyTorch's current stream as ``c_void_p``; every C
entry returns ``cudaGetLastError()`` and the wrapper raises on non-zero.

The host ingest library (``csrc/host/cfk_native.cpp``: the parsers, the
counting-sort group-by and the presence-table indexer) is built the same
way by the host C++ compiler (``c++ -O3 -shared -fPIC``) into the same
directory, named by a hash of its source and flags, on first use by
``data/_native.py``; it needs no CUDA.  The log broker
(``csrc/host/cfk_broker.cpp``) is an executable built the same way (the
flags of the JAX package's ``native/Makefile``) on first use by
``transport/tcp.py``.  Every build writes a file of its own and renames it
into place, so processes building at once never load or run a half-written
file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("reg_solve", "gram_gather", "gram_solve_dense", "topk_scores",
           "gather_rows", "gram_solve_gather", "gram_tiles_dense_gather",
           "gauss_solve", "gauss_solve_multi", "gram_tiles",
           "gram_solve_tiles", "gram_tiles_dense", "gram_solve_tiles_dense",
           "binv_solve_reg", "binv_inv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

HOST_SOURCE = CSRC_DIR / "host" / "cfk_native.cpp"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
BROKER_SOURCE = CSRC_DIR / "host" / "cfk_broker.cpp"
BROKER_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17")
BROKER_LIBS = ("-lpthread",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels are "
        "built from cfk_tpu_torch/csrc on first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not yet built, in parallel.

    Returns name → library path.  Raises with nvcc's output if any build
    fails.  nvcc's ``-Xptxas=-v`` report (registers, shared memory, spills)
    is kept beside each library as ``<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    pending = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        pending[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    errors = []
    for n, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def host_compiler() -> str:
    """The host C++ compiler from PATH (``c++``, else ``g++``)."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (c++ or g++) on PATH: the port's ingest "
        "library is built from cfk_tpu_torch/csrc/host on first use"
    )


def host_library_path() -> Path:
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"libcfk_native-{h.hexdigest()[:16]}.so"


def compile_host_library() -> Path:
    """Compile the host ingest library into a file of this call's own (a
    temporary name beside ``host_library_path()``) and return it; the
    caller loads it, checks it, and renames it into place.  Raises with the
    compiler's output if the build fails."""
    out = host_library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed for csrc/host/cfk_native.cpp "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    return tmp


def broker_binary_path() -> Path:
    h = hashlib.sha256(BROKER_SOURCE.read_bytes())
    h.update(" ".join(BROKER_FLAGS + BROKER_LIBS).encode())
    return BUILD_DIR / f"cfk_broker-{h.hexdigest()[:16]}"


def build_broker() -> Path:
    """The log broker executable, compiled first if missing (into a file of
    this call's own, renamed into place).  Raises with the compiler's
    output if the build fails."""
    out = broker_binary_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [host_compiler(), *BROKER_FLAGS, "-o", str(tmp), str(BROKER_SOURCE),
         *BROKER_LIBS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed for csrc/host/cfk_broker.cpp "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name`` (building every missing
    library first), with ``argtypes`` set and an int return."""
    key = f"{name}:{symbol}"
    with _lock:
        fn = _funcs.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                paths = build_all()
                lib = _libs[name] = ctypes.CDLL(str(paths[name]))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _funcs[key] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry of library ``name`` reported a CUDA error."""
    if rc != 0:
        describe = function(name, "cfk_error_string", [ctypes.c_int])
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({describe(rc).decode()})"
        )


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(None)
