"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (pointers and the stream are
``c_void_p``). That takes seconds; a source that included PyTorch's headers
would take minutes, and every fresh machine builds anew.

The library lands in ``deeplearning4j_tpu_torch/_build/`` (git-ignored),
named by a digest of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds
and an unchanged one loads the library already there. Publishing is a
rename of a finished temporary file, so concurrent processes never load a
half-written library. Building needs ``nvcc`` (``PATH``, ``CUDA_HOME`` or
``/usr/local/cuda``); importing this module never runs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# {C function name: (restype, argtypes)} for each source's interface
Signatures = Dict[str, Tuple[object, Sequence[object]]]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's digest
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build several sources at once, one ``nvcc`` per source."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def build_log(name: str) -> str:
    """The compiler's report from the build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed),
    with ``restype``/``argtypes`` declared for every function it exports."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _LIBS[name] = lib
        return lib
