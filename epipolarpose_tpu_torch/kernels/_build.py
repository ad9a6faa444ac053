"""Build ``csrc/*.cu`` into one shared library and load it with ``ctypes``.

One ``nvcc`` call compiles every source for ``sm_90a`` into a ``.so`` with
a plain C interface: no PyTorch headers, so the build takes seconds, not
minutes. The library goes into ``_build/<key>/`` beside this package, where
``key`` hashes the sources, the flags and ``nvcc --version``; a changed
source builds anew and an unchanged one loads at once. The build writes a
temporary file and renames it into place, so concurrent builders need no
lock file and a reader never sees a half-written library.

Every exported function returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. ``ptxas -v``'s
report (each kernel's registers, shared memory and spills) is kept beside
the library; :func:`kernel_resources` reads it.

Launches go to PyTorch's current stream (:func:`launch_args`), so a
CUDA-graph capture on that stream records them. ``cudaSetDevice`` and
``cudaGetLastError`` are legal during a capture: neither synchronises nor
touches the stream. A wrapper counts its launches through
``telemetry.count``, which a graph's replay adds again.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
import uuid

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libepipolarpose_kernels.so"
PTXAS_LOG = "ptxas.log"
# -Xptxas=-v: the report of registers and spills, kept beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_p = ctypes.c_void_p
_i = ctypes.c_int
# exported C functions: name -> argument types (all return cudaError_t)
SIGNATURES = {
    "epk_softargmax_fwd": (_p, _p, _p, _i, _i, _i, _i, _i, _i, _p),
    "epk_softargmax_bwd": (_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p),
    "epk_matmul_stats": (_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p),
    "epk_matmul_stats_simt": (_p, _p, _p, _p, _i, _i, _i, _i, _p),
    "epk_triangulate": (_p, _p, _i, _p, _p, _p, _i, _i, _i, _i, _p),
    "epk_triangulate_split": (_p, _p, _i, _p, _p, _p, _i, _i, _i, _i, _p),
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install directory."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_key(srcs, nvcc_version: str) -> str:
    """Content hash of the sources, the flags and the compiler version."""
    h = hashlib.sha256()
    h.update(nvcc_version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:24]


def nvcc_command(nvcc: str, srcs, out: os.PathLike) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def build(verbose: bool = False) -> tuple[pathlib.Path, float]:
    """Compile the sources unless a library for them exists.

    Returns (path of the library, seconds spent compiling; 0 if cached).
    """
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True, text=True).stdout
    srcs = sources()
    out_dir = BUILD_DIR / build_key(srcs, version)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{os.getpid()}.{uuid.uuid4().hex}.tmp"
    tmp = out_dir / f".{LIB_NAME}.{stem}"
    tmp_log = out_dir / f".{PTXAS_LOG}.{stem}"
    cmd = nvcc_command(nvcc, srcs, tmp)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        tmp_log.write_text(res.stdout + res.stderr)
        os.replace(tmp_log, out_dir / PTXAS_LOG)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        tmp_log.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


def kernel_resources(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's registers a thread and spill bytes (stores and loads)
    from a ``ptxas -v`` report, by its mangled name."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name]["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.epk_error_string.argtypes = [ctypes.c_int]
    lib.epk_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.epk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def current_stream(index: int) -> int:
    """PyTorch's current stream on device ``index`` as an integer handle
    (``torch.cuda.current_stream(index).cuda_stream`` without building a
    ``Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch_args(device: torch.device) -> tuple[int, int]:
    """(device index, PyTorch's current stream on it as an integer handle),
    the last two arguments of every exported launch function."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return index, current_stream(index)

