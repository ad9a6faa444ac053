"""Build one C++ source into a shared library with ``g++`` and load it
with ctypes: the native loader's and the JPEG decoder's common part.

The library goes into ``epipolarpose_tpu_torch/_build/<name>-<key>/``,
where ``key`` hashes the source, the flags and ``g++ --version``: a
changed source builds anew, an unchanged one loads at once. The build
writes a temporary file and renames it into place, so concurrent builds
need no lock and no reader sees a half-written library. A failed build is
remembered: ``available()`` is then false and ``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import uuid

BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"


class CxxLibrary:
    """One source, its flags and its exported C functions (name ->
    (result type, argument types))."""

    def __init__(self, name: str, source: pathlib.Path, cxx_flags: tuple,
                 ld_flags: tuple, signatures: dict, what: str):
        self.name, self.source, self.what = name, source, what
        self.cxx_flags, self.ld_flags = cxx_flags, ld_flags
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._error: str | None = None

    def build_key(self, cxx_version: str) -> str:
        """Content hash of the source, the flags and the compiler
        version."""
        h = hashlib.sha256()
        h.update(cxx_version.encode())
        h.update(" ".join(self.cxx_flags + self.ld_flags).encode())
        h.update(self.source.read_bytes())
        return h.hexdigest()[:24]

    def build(self) -> pathlib.Path:
        """Compile unless a library for this source exists; its path.
        Raises RuntimeError when ``g++`` is missing or fails."""
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found")
        version = subprocess.run([cxx, "--version"], check=True,
                                 capture_output=True, text=True).stdout
        out_dir = BUILD_DIR / f"{self.name}-{self.build_key(version)}"
        lib = out_dir / f"lib{self.name}.so"
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{lib.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
        cmd = [cxx, *self.cxx_flags, str(self.source), *self.ld_flags, "-o",
               str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                errors = [ln for ln in res.stderr.splitlines()
                          if "error" in ln]
                raise RuntimeError(f"g++ failed ({res.returncode}): "
                                   + ("; ".join(errors)
                                      or res.stderr.strip()))
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
        return lib

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first use); RuntimeError when it
        cannot be built or loaded."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise RuntimeError(self._error)
            try:
                lib = ctypes.CDLL(str(self.build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                self._error = f"{self.what} unavailable: {e}"
                raise RuntimeError(self._error) from e
            for fname, (restype, argtypes) in self.signatures.items():
                fn = getattr(lib, fname)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            self._lib = lib
            return lib

    def available(self) -> bool:
        try:
            self.load()
            return True
        except RuntimeError:
            return False

    def build_error(self) -> str | None:
        return self._error

    def library_path(self) -> pathlib.Path | None:
        return None if self._lib is None else pathlib.Path(self._lib._name)
