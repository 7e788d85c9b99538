"""Hand-written Hopper kernels of the port, their build, and launch counts.

Each kernel package mirrors the reference's Pallas package:
  <name>/csrc/*.cu  — CUDA C++ for sm_90a with a plain C interface
  <name>/kernel.py  — the ctypes binding: operand checks, launch, counter
  <name>/ref.py     — the plain-torch version of the same function
  <name>/ops.py     — the public wrappers

  gossip_blend   B1r/B1a, B2r/B2a, B3r/B3a (gossip_blend/csrc/gossip_blend.cu)
  kmeans_assign  B4, the fused K-Means E/M step (its own source)
  parzen_blend   B6r/B6a, the P=1 gate and blend: two entry points of the
                 gossip-blend source, bound in parzen_blend/kernel.py
  ssd_scan       B5, the Mamba-2 chunked SSD scan (ssd_scan/csrc/ssd_scan.cu),
                 and B5b, its backward (ssd_scan/csrc/ssd_scan_bwd.cu); both
                 include the split-TF32 helpers of ssd_scan/csrc/tf32_mma.cuh

Build: ``nvcc`` compiles each source into its own shared library under
``build/kernels/`` at the repo root (listed in .gitignore) the first time a
wrapper meets a CUDA tensor, and ``ctypes`` loads it.  A library's name
holds a hash of its source, of the headers the source includes from its
own directory (:func:`local_headers`) and of the flags, so an edit to any
of them builds anew.  Nothing is compiled
at import: the CPU tests import every module on a machine without nvcc.
:func:`build_all` starts one nvcc per source, all at once.

Launch counts: every wrapper calls :func:`count_launch` right after its
kernel launched, and nowhere else — so a run can show that its main path
went through the kernels (chip_smoke.py resets and reads them).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import threading

# f32 lane width of the packed (R, LANE) state layout, shared by the
# gossip-blend kernels and the pack-once layer (core/packing.py)
LANE = 512

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: each kernel rounds every product
    # and sum on its own, as its plain-torch version does
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC")

_launches: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def kernel_sources() -> list[pathlib.Path]:
    """Every CUDA source of the port, one shared library each."""
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_headers(source: pathlib.Path) -> list[pathlib.Path]:
    """The headers ``source`` includes by ``#include "name"`` from its own
    directory, and those they include in turn, sorted."""
    found, todo = set(), [pathlib.Path(source)]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            path = pathlib.Path(source).parent / name.decode()
            if path.is_file() and path not in found:
                found.add(path)
                todo.append(path)
    return sorted(found)


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Build output of ``source``, keyed by its content, the content of the
    headers it includes from its own directory, and the flags."""
    source = pathlib.Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=None) -> dict:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together.  Returns {source: library path}; raises
    with nvcc's output if any build fails."""
    sources = [pathlib.Path(s) for s in (sources or kernel_sources())]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in sources:
        lib = library_path(src)
        out[src] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)   # atomic: concurrent builders never
            #                        load a half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """The loaded shared library of ``source``, built on first use."""
    source = pathlib.Path(source)
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = build_all([source])[source]
            lib = _libs[source] = ctypes.CDLL(str(path))
        return lib
