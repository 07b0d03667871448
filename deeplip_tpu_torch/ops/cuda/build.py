"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

under ``deeplip_tpu_torch/_build/<hash of the sources>/``, so an edited
source builds anew and an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them together. A
missing ``nvcc`` or a failed build raises with the compiler's output.

This module is also where every kernel is launched. A wrapper types its
library's C entries once, through :func:`entries`, and launches each of
them through :func:`launch`, which checks the ``cudaError_t`` it returns
and counts the launch in :data:`LAUNCHES` under the keys the wrapper's
signature table names for that entry. :func:`add_launches` is the table's
only other writer, for launches a CUDA graph replays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path
from typing import Callable, Mapping, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def kernel_names() -> list[str]:
    """Names of the kernel sources: ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "toolkit is needed to build the port's kernels")


def library_path(name: str) -> Path:
    return BUILD_ROOT / _sources_hash() / f"lib{name}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, started together. Returns the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) per built
    library."""
    names = kernel_names() if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        # a name of this call's own: two threads, or two processes, that
        # build the same library never write the same file
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".tmp", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so``, building it first if needed.
    Build-and-load runs under one lock, so threads that reach a kernel's
    first launch together start one ``nvcc`` and get the same library."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


# Kernel launches in this process, by the kernel (or pair of passes) a
# wrapper launches: the front-end's FFT and mixed-radix plans, K3 and K4
# (the fused BN+PReLU forward and backward) and, of their launches, the
# split finalize under a process group, the BN+PReLU eval apply of the
# ResNet trunk's sites, the max-pool's forward and backward, the frontend
# Conv3d's weight gradient, and T's train forward, train backward and eval
# apply (the TDNN blocks' fused BN + LeakyReLU).
LAUNCHES: dict[str, int] = dict.fromkeys(
    ("fft", "mixed", "bn_prelu_fwd", "bn_prelu_bwd", "bn_totals_fwd", "bn_totals_bwd",
     "bn_prelu_eval", "maxpool_fwd", "maxpool_bwd", "conv3d_wgrad", "tdnn_fwd", "tdnn_bwd",
     "tdnn_eval"), 0)


def entries(library: str,
            signatures: Mapping[str, tuple[Sequence[str], Sequence]]) -> Callable[[str], tuple]:
    """A cached loader of ``lib<library>.so``'s C entries. ``signatures``
    maps an entry's name to ``(keys, argtypes)``: the :data:`LAUNCHES` keys a
    launch of it counts under and its C argument types. The loader takes an
    entry's name and returns ``(function, keys)``, the function typed with
    an ``int`` return (its ``cudaError_t``); the library is built and loaded
    at the first call, and each entry typed once."""
    @lru_cache(maxsize=None)
    def entry(name: str) -> tuple:
        keys, argtypes = signatures[name]
        fn = getattr(load(library), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn, keys
    return entry


def launch(entry: tuple, *args) -> None:
    """Call an entry of :func:`entries` with ``args``; a nonzero
    ``cudaError_t`` raises, naming the entry, and a launch that returned 0
    adds one to each of its keys in :data:`LAUNCHES`."""
    fn, keys = entry
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {err}")
    for key in keys:
        LAUNCHES[key] += 1


def add_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` to :data:`LAUNCHES`, key by key: the launches a CUDA
    graph's replay makes without calling :func:`launch`, or, negative, the
    ones counted while it was captured, which ran no kernel."""
    for key, n in counts.items():
        LAUNCHES[key] += n
