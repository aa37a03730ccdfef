"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers,
so nvcc takes seconds, not minutes), may include the shared ``csrc/*.cuh``
headers, and is compiled for ``sm_90a`` into a
shared library that ``ctypes`` loads. Builds happen at first use, from the
package's own sources, into ``_build/`` beside them (listed in .gitignore).
A library's file name carries a hash of its source and the flags, so an
edited source is rebuilt and an unchanged one reused. ``build`` starts one
nvcc process per missing library, all at once; each library's build log
is kept beside it (``build_log``). Host code (``csrc/<name>.cpp``, plain C
interface too) is compiled the same way with g++ by ``build_host``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, in the build log
)
NVCC_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the port's CUDA "
        "kernels are compiled from csrc/ at first use on the machine with the card"
    )


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def kernel_sources() -> list[str]:
    """The names of every CUDA kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names) -> dict[str, str]:
    """Compile every named kernel source whose library is missing, with one
    nvcc process each, all started together. Returns each compiled name's
    build log (ptxas's register and spill report); raises on any failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                out,
            )
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                out.with_suffix(".log").write_text(logs[name])
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The build log of the library ``name`` as it stands (ptxas's report),
    kept beside it; the library is built first if needed."""
    build([name])
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed; loaded once per process."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


# -- host code ------------------------------------------------------------------

GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120


def host_library_path(name: str) -> Path:
    """The host library's path; its hash covers the source and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> None:
    """Compile ``csrc/<name>.cpp`` with g++ unless its library exists; raises
    on a failed build (OSError when there is no g++)."""
    out = host_library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")],
                              capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"g++ build of {name} failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name``, built first if needed; loaded once per process."""
    lib = _loaded.get(f"host:{name}")
    if lib is None:
        build_host(name)
        lib = _loaded[f"host:{name}"] = ctypes.CDLL(str(host_library_path(name)))
    return lib
