"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source compiles with ``nvcc`` for ``sm_90a`` into a plain-C shared
library, loaded with ``ctypes``.  The library lands in ``_build/`` beside
this package (listed in ``.gitignore``), named after a hash of every
source and header of ``csrc/`` and the flags, so an edited source builds
anew and an unchanged one loads at once.  The compiler's
register/shared-memory report (``-Xptxas -v``) is kept beside the library
as ``<name>.log``.  ``build_all`` runs one ``nvcc`` per source, all at once;
``sass_count`` counts an instruction in a built library.

Below the build, the helpers every kernel wrapper shares: binding a C
entry, checking its tensors, the stream and device of a launch, raising on
a returned CUDA error, the libraries of a kernel built once per dtype
(``DtypeKernel``) and the autograd.Function of a forward-only kernel
(``forward_only``).
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        f"{name} not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "calodiffusion_tpu_torch are built on first use"
    )


def _nvcc() -> str:
    return _cuda_tool("nvcc")


def sass_count(library: Path, opcode: str) -> int:
    """How many instructions of ``opcode`` (such as ``HGMMA``, the SASS of
    wgmma) the built ``library`` holds, by ``cuobjdump -sass``."""
    proc = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {library}:\n{proc.stderr}")
    count = 0
    for line in proc.stdout.splitlines():  # "/*0120*/  [@P0] HGMMA.64x64x16.F32.BF16 ... ;"
        words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
        count += "*/" in line and bool(words) and words[0].startswith(opcode)
    return count


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the build of ``csrc/<name>.cu`` with the macros ``defines``
    (``"NAME=value"``) goes, keyed on csrc's sources, the macros and the flags."""
    # every source of csrc/: a source may include another (K3 includes K1's)
    sources = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cu*")))
    flags = " ".join((*NVCC_FLAGS, name, *defines)).encode()
    digest = hashlib.sha256(sources + flags).hexdigest()
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


# ---------------------------------------------------------------------------
# Calling a kernel's C entry from its wrapper
# ---------------------------------------------------------------------------

def bind(lib: ctypes.CDLL, entry: str, argtypes) -> ctypes.CDLL:
    """Declare the argument types of ``lib``'s C entry ``entry`` (each
    returns a CUDA error code)."""
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` lies on ``device`` with this shape and dtype,
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(dev) -> int:
    """The handle of PyTorch's current stream on ``dev`` (0 off the card)."""
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else 0


def on_device(t):
    """``t``'s card as the current device for a launch; a no-op for a tensor
    off the card (the kernels' CPU emulation in the tests)."""
    return torch.cuda.device(t.device if t.device.type == "cuda" else -1)


def raise_on(rc: int, kernel: str, t) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc} "
                           f"(shape {tuple(t.shape)}; {t.dtype})")


def dtype_variant(dtype) -> tuple[str]:
    """The macro of a build for one dtype: ``CALO_BF16=1`` bf16, ``0`` f32."""
    return (f"CALO_BF16={int(dtype == torch.bfloat16)}",)


class DtypeKernel:
    """A kernel of ``csrc/<name>.cu`` with its C entries (``{entry:
    argtypes}``), built once per dtype (bf16, f32): each library holds one
    instantiation."""

    def __init__(self, name: str, entries: dict):
        self.name, self.entries = name, entries
        # every (kernel, variant) a caller may launch
        self.builds = tuple((name, dtype_variant(dt)) for dt in (torch.bfloat16, torch.float32))
        self._libraries = {}

    def bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Declare the argument and result types of ``lib``'s entries."""
        for entry, argtypes in self.entries.items():
            bind(lib, entry, argtypes)
        return lib

    def library(self, t) -> ctypes.CDLL:
        """The library for ``t``'s dtype, built at first use; ``t`` must
        lie on the card."""
        if t.device.type != "cuda":
            raise ValueError(f"the {self.name} kernel runs on CUDA tensors, got {t.device}")
        if t.dtype not in self._libraries:
            self._libraries[t.dtype] = self.bind(load(self.name, dtype_variant(t.dtype)))
        return self._libraries[t.dtype]


def forward_only(forward, kernel: str, jax_source: str, instead: str):
    """A torch.autograd.Function whose forward is ``forward`` (a kernel's
    counted wrapper) and whose backward raises: the kernel has no backward,
    as its JAX counterpart in ``jax_source`` defines no VJP, and the port
    does not quietly differentiate the plain version in its place."""
    message = (f"{kernel} is forward only, as the JAX package's ({jax_source} defines no "
               f"VJP); differentiate {instead} instead")

    class ForwardOnly(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            return forward(*args)

        @staticmethod
        def backward(ctx, *grads):
            raise NotImplementedError(message)

    return ForwardOnly
