"""The CUDA stats DP (``native/stats_dp.cu``) as a JAX operation.

The shared library is built from the committed source with ``nvcc`` at
first use, into ``native/_build/`` (git-ignored), and registered as an XLA
FFI target for the CUDA platform.  To build it ahead of a run:

    python -m ngspeciesid.ops.stats_cuda

A failure to build or load raises: on a GPU host the device DP never falls
back to the host engine silently.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import threading

import numpy as np

import jax
import jax.numpy as jnp

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE, "stats_dp.cu")
_BUILD = os.path.join(_NATIVE, "_build")
_SO = os.path.join(_BUILD, "libstatsdp.so")
_TARGET = "ngsid_stats_dp"
_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc")
        if root and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the device stats DP needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the library if it is missing or older than its source."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)   # ranks of one host build once
        if (os.path.isfile(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building the device stats DP failed:\n{res.stderr[-4000:]}")
        os.replace(tmp, _SO)
    return _SO


def ensure_registered() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.NgsidStatsDp), platform="CUDA")
        _registered = True


#: threads per block the kernel aims for: a 256-lane window (band 150)
#: then runs as 128 threads of two lanes each.  On an H100 that split took
#: ~20% less time per 4,096-pair launch than one lane per thread; four
#: lanes took another 3-12% less, too little to move a run whose stats DP
#: time is mostly host work (CHANGES.md; scripts/dp_launch_cost.py
#: measures it again)
TARGET_THREADS = 128


def lanes_per_thread(W: int) -> int:
    """Lanes each thread owns (1, 2, 4 or 8) for a window of ``W`` lanes."""
    R = 1
    while R < 8 and -(-W // R) > TARGET_THREADS:
        R *= 2
    return R


@functools.partial(jax.jit, static_argnames=(
    "W", "n", "m", "band", "match", "mismatch", "gap_ext", "lanes"))
def _call(pool, table, base, *, W, n, m, band, match, mismatch, gap_ext,
          lanes):
    return jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct((table.shape[0], 16), jnp.int32))(
            pool, table, base, W=np.int32(W), band=np.int32(band),
            match=np.int32(match), mismatch=np.int32(mismatch),
            gap_ext=np.int32(gap_ext), n_cap=np.int32(n),
            m_cap=np.int32(m), lanes_per_thread=np.int32(lanes))


def stats_rows(pool, table, base, *, W, n, m, band, match, mismatch,
               gap_ext, lanes=None):
    """(B, 16) int32 result rows of the CUDA kernel (see align_stats.py).
    ``lanes`` overrides :func:`lanes_per_thread` (scripts/dp_launch_cost.py
    times the split)."""
    ensure_registered()
    return _call(pool, table, base, W=W, n=n, m=m, band=band, match=match,
                 mismatch=mismatch, gap_ext=gap_ext,
                 lanes=lanes or lanes_per_thread(W))


if __name__ == "__main__":
    print(build())
