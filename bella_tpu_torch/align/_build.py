"""Build and load the hand-written CUDA kernels of the port.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``bella_tpu_torch/_build/`` (listed in ``.gitignore``; see
``utils/shlib.py``), and loaded with ctypes. Nothing is built when the
module is imported: the CPU tests import every module and never launch a
kernel.

Each wrapper counts its launches in ``utils/log.py``'s ``COUNTS``
(``launch.<kernel>``) where it launches its kernel and nowhere else; the
reads' ragged pack (``launch.pack_ragged``) counts the reads it packs
there too (``align.packed_reads``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from bella_tpu_torch.utils import log, shlib

_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the kernels (K1 static band, K2 adaptive: the main path's; K3 extension
# prep: the tests' and tools' materialised streams) and the x-drop
# launches that took the long-key instantiation
KERNELS = ("xdrop_static", "xdrop_adaptive", "ext_prep",
           "xdrop_static_long_key", "xdrop_adaptive_long_key")


def launches() -> dict:
    """Launches by kernel since the log's last reset, every kernel named."""
    return {k: log.COUNTS.get("launch." + k, 0) for k in KERNELS}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{_CSRC} on first use and need the CUDA toolkit"
    )


def build(source: str) -> Path:
    """Compile csrc/<source> (if its content changed) and return the .so
    path; nvcc's output (ptxas registers and spills per kernel) goes to
    the .log beside it. Raises with nvcc's output when the build fails."""
    src = _CSRC / source
    return shlib.compile_shared(src, src.stem, _nvcc(), NVCC_FLAGS)


def _bind_xdrop(lib: ctypes.CDLL) -> None:
    fn = lib.bella_xdrop_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, vp, vp, ll, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                   vp, vp, vp, vp, vp]
    fn.restype = ctypes.c_int
    lib.bella_xdrop_slots.argtypes = [i, i]
    lib.bella_xdrop_slots.restype = ctypes.c_int
    lib.bella_prep_launch.argtypes = [vp, ll, vp, vp, vp, i, i, i,
                                      vp, vp, vp, vp, vp, vp, vp]
    lib.bella_prep_launch.restype = ctypes.c_int
    lib.bella_pack_launch.argtypes = [vp, vp, i, ll, vp, vp]
    lib.bella_pack_launch.restype = ctypes.c_int


def xdrop_lib() -> ctypes.CDLL:
    """The kernel library (csrc/xdrop.cu: K1 and K2, K3, and the reads'
    ragged pack), built on first use."""
    return shlib.load("xdrop", lambda: build("xdrop.cu"), _bind_xdrop)
