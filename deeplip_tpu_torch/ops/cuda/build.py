"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

under ``deeplip_tpu_torch/_build/<hash of the sources>/``, so an edited
source builds anew and an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them together. A
missing ``nvcc`` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

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
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
