"""ctypes loader for the native (C++) linearizability checker.

``host/csrc/lincheck.cpp`` implements the checker's precedence-graph
cycle search (history.go semantics, the same algorithm as
``host/history.py``) as a shared library with a plain C interface.  It is
built at first use with ``g++ -O2 -shared -fPIC`` into ``build/native/``
at the repository root (listed in ``.gitignore``), under a name that
carries a hash of its source, so an edited source rebuilds.  Without a
compiler, or with ``PAXI_TPU_NO_NATIVE`` set, ``check_key_native``
answers None and ``history.check_key`` keeps the pure-Python path (the
same answers); ``native_available()`` says which one runs, so a caller
that needs the library can refuse a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

EMPTY_VAL = -2

SOURCE = Path(__file__).resolve().parent / "csrc" / "lincheck.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lincheck: Optional[ctypes.CDLL] = None
_tried = False
# why the last load failed ("" when it succeeded or was never tried)
build_error = ""
# histories the C++ checker answered in this process
calls = 0


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"liblincheck-{digest[:16]}.so"


def _build(lib: Path) -> str:
    """Compile the source into ``lib``; "" on success, else the reason.
    The compiler writes a temporary file renamed into place once it
    succeeded, so concurrent first uses never load half a library."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return "no C++ compiler (g++) on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cxx} failed: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{cxx} exited {r.returncode}: {r.stderr.strip()[-2000:]}"
    os.replace(tmp, lib)
    return ""


def load_lincheck() -> Optional[ctypes.CDLL]:
    """The checker library, built on first use; None if it cannot be
    built or loaded (``build_error`` says why) or ``PAXI_TPU_NO_NATIVE``
    is set."""
    global _lincheck, _tried, build_error
    if _tried:
        return _lincheck
    _tried = True
    if os.environ.get("PAXI_TPU_NO_NATIVE"):
        build_error = "PAXI_TPU_NO_NATIVE is set"
        return None
    lib_path = library_path()
    if not lib_path.exists():
        build_error = _build(lib_path)
        if build_error:
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.lincheck_key.restype = ctypes.c_int32
        lib.lincheck_key.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
        ]
        if lib.lincheck_version() != 1:
            build_error = f"{lib_path.name}: unexpected lincheck_version"
            return None
        _lincheck = lib
    except OSError as e:
        build_error = f"{lib_path.name}: {e}"
    return _lincheck


def native_available() -> bool:
    """True when ``check_key_native`` runs the C++ checker."""
    return load_lincheck() is not None


def check_key_native(ops) -> Optional[int]:
    """Native check_key (host/history.py semantics); None if unavailable."""
    global calls
    lib = load_lincheck()
    if lib is None:
        return None
    n = len(ops)
    is_read = (ctypes.c_int32 * n)()
    val = (ctypes.c_int64 * n)()
    start = (ctypes.c_double * n)()
    end = (ctypes.c_double * n)()
    ids = {}

    def vid(b: bytes) -> int:
        if b not in ids:
            ids[b] = len(ids)
        return ids[b]

    for i, o in enumerate(ops):
        is_read[i] = 1 if o.is_read else 0
        if o.is_read:
            val[i] = vid(o.output) if o.output else EMPTY_VAL
        else:
            val[i] = vid(o.input) if o.input is not None else EMPTY_VAL
        start[i] = o.start
        end[i] = o.end
    calls += 1
    return int(lib.lincheck_key(is_read, val, start, end, n))
