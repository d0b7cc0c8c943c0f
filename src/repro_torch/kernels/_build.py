"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/repro_torch_ext/`` at the repository root (a directory
``.gitignore`` lists).  The library is named by a hash of its source, the
shared headers beside it (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one is a cache hit.
It is bound through ``ctypes``: pointers come from ``tensor.data_ptr()``
and the stream from ``torch.cuda.current_stream().cuda_stream``.

The first conv runs at once on every in-process slave thread (the
cluster's ``probe()``), so each library's build is serialised by its own
lock (different sources still build side by side), and the library is
installed by an atomic rename so that concurrent slave processes never
load a half-written file.  Nothing here runs at import:
the CPU tests import every module, and this host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = (
    "-O3", "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class BuiltLibrary:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    build_s: float  # wall-clock seconds of this process's nvcc call (0 on a hit)
    cache_hit: bool
    ptxas: str  # nvcc's ``-Xptxas -v`` report: registers, shared memory, spills


# ctypes signatures of each library's C interface: every pointer and the
# stream as c_void_p (a bare Python int would be cut to 32 bits).
_SIGNATURES = {
    "conv2d_fwd": {
        "conv2d_fwd_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
            ctypes.c_int,
        ),
        "conv2d_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "conv2d_bwd": {
        "conv2d_dx_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
            ctypes.c_int,
        ),
        "conv2d_dw_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "conv2d_bwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "flash_attn_fwd": {
        "flash_attn_fwd_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            ctypes.c_int,
        ),
        "flash_attn_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "ssd_fwd": {
        "ssd_fwd_launch": (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "ssd_fwd_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_longlong),
        "ssd_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}

_LOCKS = {name: threading.Lock() for name in _SIGNATURES}
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it.

    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    with _LOCKS[name]:
        if name in _LOADED:
            return _LOADED[name]
        src = CSRC / f"{name}.cu"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{name}_{digest}.so"
        log = so.with_suffix(".ptxas.txt")
        build_s, hit = 0.0, so.exists()
        if not hit:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed building {src.name} (rc={proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        built = BuiltLibrary(
            lib=lib, path=so, build_s=build_s, cache_hit=hit,
            ptxas=log.read_text() if log.exists() else "",
        )
        _LOADED[name] = built
        return built


def conv2d_fwd_library() -> ctypes.CDLL:
    """The bound ``conv2d_fwd`` library, built on first call."""
    return build("conv2d_fwd").lib


def conv2d_bwd_library() -> ctypes.CDLL:
    """The bound ``conv2d_bwd`` library (dX and dW), built on first call."""
    return build("conv2d_bwd").lib


def flash_attn_fwd_library() -> ctypes.CDLL:
    """The bound ``flash_attn_fwd`` library (K4), built on first call."""
    return build("flash_attn_fwd").lib


def ssd_fwd_library() -> ctypes.CDLL:
    """The bound ``ssd_fwd`` library (K5), built on first call."""
    return build("ssd_fwd").lib
