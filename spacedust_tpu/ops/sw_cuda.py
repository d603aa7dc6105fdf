"""The Hopper Smith-Waterman scan (cuda/sw_scan.cu) as a JAX operation.

The kernel is CUDA C++ for sm_90a, built with nvcc from the committed
source into `cuda/_build/` (listed in .gitignore) at first use, or ahead
of time with `python -m spacedust_tpu.ops.sw_cuda`.  The library's name
carries a hash of the source, the nvcc version, the target and the
flags, so a library built elsewhere is never loaded.  It is registered
as the XLA FFI target `spacedust_sw_scan` for the CUDA platform.

The kernel reads the resident int8 token and bias arrays at each pair's
token offsets itself (reversed for the reverse pass), so a batch moves
only its (6, B) params array and its (6, B) results.  Its arithmetic is
that of ops/sw_tiled.sw_scan_core, which stays the plain reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_DIR = Path(__file__).resolve().parent / "cuda"
_SRC = _DIR / "sw_scan.cu"
_BUILD = _DIR / "_build"
ARCH = "sm_90a"
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         f"-gencode=arch=compute_90a,code={ARCH}")
TARGET = "spacedust_sw_scan"
# a stripe holds at most 32 lanes x 16 rows; longer queries hand their
# bottom row from stripe to stripe through the carry buffer
STRIPE_ROWS = 512

_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA SW kernel is built "
                           "from source on the GPU host")
    return nvcc


def library_path(nvcc: str | None = None) -> Path:
    """Where the library for this source, compiler, target and flag set
    lives."""
    nvcc = nvcc or _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha1()
    for part in (_SRC.read_bytes(), version.encode(), ARCH.encode(),
                 " ".join(FLAGS).encode()):
        h.update(part)
    return _BUILD / f"libsw_scan_{ARCH}_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernel library unless this exact build exists.  The
    output is written under a private name and renamed, so concurrent
    builders never load a half-written file."""
    nvcc = _nvcc()
    out = library_path(nvcc)
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    from ..utils.cache import unique_tmp
    tmp = unique_tmp(out)
    cmd = [nvcc, *FLAGS, "-I", jax.ffi.include_dir(), "-o", str(tmp),
           str(_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def register() -> None:
    """Build, load and register the kernel once per process; fails
    without a GPU."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return
        if not any(d.platform == "gpu" for d in jax.devices()):
            raise RuntimeError("the CUDA Smith-Waterman kernel needs a GPU, "
                               f"and JAX found {jax.devices()[0].platform}")
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.SpacedustSwScan), platform="CUDA")
        _LIB = lib


def carry_shape(B: int, Lq: int, Lt: int) -> tuple[int, ...]:
    """Scratch for the stripe-to-stripe hand-off: (H, F, column max, its
    row) per column, double-buffered, for rungs whose queries can span
    more than one stripe; a placeholder otherwise."""
    if Lq > STRIPE_ROWS:
        return (B, 2, Lt, 4)
    return (1,)


def sw_scan_gpu(qdata, qbias, tdata, sub, params, *, Lq: int, Lt: int,
                gap_open: int, gap_extend: int, reverse: bool):
    """qdata/qbias/tdata: resident int8 arrays; sub: (A, A) int32;
    params: (6, B) int32 rows qoff, qlen, toff, tlen, terminate, unused
    (offsets in tokens).  Returns (score, gj, gi, found, fj, fi), each
    (B,) int32, as sw_scan_core(all_outputs=True) does."""
    register()
    B = params.shape[1]
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((6, B), jnp.int32),
         jax.ShapeDtypeStruct(carry_shape(B, Lq, Lt), jnp.int32)))(
        qdata, qbias, tdata, sub.astype(jnp.int32), params,
        reverse=np.int32(bool(reverse)), gap_open=np.int32(gap_open),
        gap_extend=np.int32(gap_extend), lq=np.int32(Lq), lt=np.int32(Lt))
    return tuple(out[i] for i in range(6))


if __name__ == "__main__":
    print(build())
