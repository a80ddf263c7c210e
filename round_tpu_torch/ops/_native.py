"""Build and load the hand-written CUDA kernels (``round_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into its own shared library, loaded with ``ctypes``.  The build runs at
first use, all sources in parallel, into ``round_tpu_torch/_build/<key>/``
where ``<key>`` hashes the sources and the flags, so an edited source
rebuilds and an unchanged one loads.  Nothing here runs at import time.

Every wrapper takes the lean launch route: it binds the entry points it
calls once (``bind``, which loads the library behind a lock at first use)
and keeps them in a module global, passes the device index, and takes the
current stream of that device from ``raw_stream``, with no ``Stream``
object, no device context and no lock.  The C entry point makes the device
current only when it is not, and K1-K3 raise a kernel's shared-memory
limit once per size, not on every launch (csrc/launch.cuh).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("hist_exchange", "hist_loop", "lv_loop", "probe", "ring_exchange")

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
# the three K1 instances of csrc/hist_loop.cu share one C signature
_LOOP = {
    f"{algo}_loop_{fn}": sig
    for algo in ("otr", "floodmin", "benor")
    for fn, sig in (("launch", ([_P] * 11 + [_I] * 7 + [_P], _I)),
                    ("smem_bytes", ([_I, _I, _I], ctypes.c_size_t)),
                    ("onehot_bytes", ([_I, _I], ctypes.c_size_t)))
}
# C signatures: library -> {function: (argtypes, restype)}
_SIGNATURES = {
    "hist_exchange": {
        "hist_exchange_launch": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "hist_exchange_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "hist_loop": _LOOP,
    "lv_loop": {
        "lv_loop_launch": ([_P] * 10 + [_I] * 4 + [_P], _I),
        "lv_loop_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "probe": {
        "probe_double_launch": ([_P, _P, _L, _I, _P], _I),
        "philox_bits_launch": ([_P, _P, _L] + [_U] * 4 + [_I, _P], _I),
    },
    "ring_exchange": {
        "ring_gather_local_launch": ([_PP] * 2 + [_I] * 9 + [_P], _I),
        "ring_gather_peers_launch": ([_PP] * 3 + [_P] + [_I] * 9
                                     + [_U, _L, _I, _P], _I),
        "ring_exchange_max_blocks": ([_I], _I),
        "ring_enable_peer": ([_I, _I], _I),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_RAW_STREAM = None  # torch._C._cuda_getCurrentRawStream, at first use


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_key() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / build_key()


def build() -> Tuple[Path, float]:
    """Compile every kernel that is not built yet, all at once.  Returns
    (build directory, seconds spent compiling).  Raises with nvcc's output
    when a source does not compile."""
    import time

    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [k for k in KERNELS if not (out_dir / f"lib{k}.so").exists()]
    t0 = time.perf_counter()
    if not todo:
        return out_dir, 0.0
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out_dir, time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register/shared-memory lines) for a kernel."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            out_dir, _ = build()
            so = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = restype
            _LIBS[name] = so
        return _LIBS[name]


def bind(name: str, *functions: str) -> Tuple:
    """The entry points `functions` of kernel `name`, built and loaded
    first if needed, for a wrapper to keep in a module global."""
    so = lib(name)
    return tuple(getattr(so, fn) for fn in functions)


def raw_stream(index: int) -> int:
    """The current stream of CUDA device `index`, as the raw ``cudaStream_t``
    a C entry point takes.  The binding exists only in CUDA builds of
    PyTorch, so it is looked up at the first call, never at import."""
    global _RAW_STREAM
    if _RAW_STREAM is None:
        import torch

        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
    return _RAW_STREAM(index)


def pointer_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers, for a C parameter
    ``int* const* outs``."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
