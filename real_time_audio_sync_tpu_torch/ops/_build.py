"""Build and load the port's CUDA kernels: ``nvcc`` compiles each
``csrc/<name>.cu`` into a shared library with a plain C interface, loaded
with ``ctypes``.

The build runs at first use, from the package's own sources, into
``csrc/build/`` (ignored by git); the library name carries a digest of the
source, of every header in ``csrc/`` and of the flags, so an edited source
or header rebuilds.  A missing ``nvcc`` or a
failed build raises — nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: the C signature of each kernel library's entry points
SIGNATURES = {
    "otw_insert": {
        "otw_insert_block": (
            [_P] * 9 + [_I] * 6 + [ctypes.c_float] + [_I] * 5 + [_P],
            ctypes.c_int,
        ),
        "otw_multi_insert_block": (
            [_P] * 11 + [_I] * 4 + [ctypes.c_float] + [_I] * 5 + [_L] * 4 + [_I, _P],
            ctypes.c_int,
        ),
        "otw_error_string": ([_I], ctypes.c_char_p),
        "otw_band_workspace_floats": ([_I, _I], ctypes.c_int),
        "otw_insert_plan": ([_I] * 3 + [_P], ctypes.c_int),
    },
    "otw_set_live": {
        "otw_set_live": ([_P] * 7 + [_I] * 7 + [ctypes.c_float] + [_I] * 4 + [_P], ctypes.c_int),
        "otw_set_live_error_string": ([_I], ctypes.c_char_p),
        "otw_band_workspace_floats": ([_I, _I], ctypes.c_int),
    },
    "wavefront": {
        "wavefront_dp": ([_P] * 3 + [_L] * 3 + [_I] * 4 + [ctypes.c_double] * 3 + [_I] * 4 + [_P] * 2, ctypes.c_int),
        "wavefront_dp_workspace_bytes": ([_L, _L, _L, _I], ctypes.c_longlong),
        "wavefront_dp_resident": ([_I, _P], ctypes.c_int),
        "wavefront_dp_strip_rows": ([], ctypes.c_int),
        "wavefront_backtrack": ([_P] * 3 + [_L] * 3 + [_I] * 8 + [_P], ctypes.c_int),
        "wavefront_error_string": ([_I], ctypes.c_char_p),
    },
    "wtw_insert": {
        "wtw_insert_block": ([_P] * 5 + [_I] * 10 + [ctypes.c_double] * 3 + [_I] * 12 + [_P], ctypes.c_int),
        "wtw_multi_insert_block": (
            [_P] * 6 + [_I] * 11 + [ctypes.c_double] * 3 + [_I] * 12 + [_L] * 3 + [_P],
            ctypes.c_int,
        ),
        "wtw_insert_plan": ([_I, _I, _P], ctypes.c_int),
        "wtw_blocks_per_sm": ([_I, _I], ctypes.c_int),
        "wtw_shared_bytes": ([_I, _I], ctypes.c_int),
        "wtw_error_string": ([_I], ctypes.c_char_p),
    },
}


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc run, 0.0 when the library existed
    log: str  # nvcc's output (ptxas register and shared-memory report)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")
    return nvcc


def _compile(name: str) -> tuple[Path, float, str]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


@functools.cache
def load(name: str) -> Built:
    """The built library of ``csrc/<name>.cu``, compiled on first call."""
    path, seconds, log = _compile(name)
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return Built(lib, path, seconds, log)
