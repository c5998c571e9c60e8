"""Build and load the hand-written CUDA kernels (no reference module; the
JAX package lowers its Pallas kernels through Mosaic instead).

At first use each source in ``src/repro_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface, under ``build/`` at
the repository root (git-ignored), and loaded with ``ctypes``.  The file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.
All missing libraries compile in parallel, one ``nvcc`` per source.  A
failed build raises :class:`BuildError`; nothing falls back.  With tracing
on, each library compiled records an ``nvcc`` compile span
(``repro_torch.obs.profile``); a library found built records none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.obs import profile as PROF

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = ROOT / "build"
SOURCES = ("bea_fused", "bea_batched", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                     "built at first use and there is no fallback")


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, named by a hash of the
    source, every shared header in ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict:
    """Compile every named source whose library is missing, all at once.

    Returns {name: {"seconds": wall time, "log": compiler output}} for the
    sources compiled by this call.
    """
    todo = [n for n in names if not target(n).is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        PROF.compile_span("nvcc", report[name]["seconds"], lib=name)
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = target(name)
        if not path.is_file():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
