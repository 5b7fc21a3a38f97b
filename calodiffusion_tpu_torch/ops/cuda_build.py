"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source compiles with ``nvcc`` for ``sm_90a`` into a plain-C shared
library, loaded with ``ctypes``.  The library lands in ``_build/`` beside
this package (listed in ``.gitignore``), named after a hash of the source,
the shared headers of ``csrc/`` and the flags, so an edited source builds
anew and an unchanged one loads at once.  The compiler's
register/shared-memory report (``-Xptxas -v``) is kept beside the library
as ``<name>.log``.  ``build_all`` runs one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "calodiffusion_tpu_torch are built on first use"
    )


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the build of ``csrc/<name>.cu`` with the macros ``defines``
    (``"NAME=value"``) goes, keyed on the sources, the macros and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join((*NVCC_FLAGS, *defines)).encode()
    digest = hashlib.sha256(src + headers + flags).hexdigest()
    tag = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{digest[:16]}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-D`` of each of ``defines`` unless
    that build exists; returns the .so."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu {' '.join(defines)} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu`` with ``defines``."""
    return ctypes.CDLL(str(build(name, defines)))


def build_all(jobs) -> list[Path]:
    """Build several (name, defines) at once, one ``nvcc`` each; raises the
    first build's error after all have ended."""
    jobs = list(jobs)
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        return list(pool.map(lambda job: build(*job), jobs))
