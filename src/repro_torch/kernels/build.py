"""Build step of the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Sources come only from the repository: the emitters of
:mod:`repro_torch.kernels.stencil3d` and :mod:`~repro_torch.kernels.stream3d`,
and ``swa.cu`` and ``swa_mma.cu`` specialised by
:mod:`repro_torch.kernels.swa`.  Each library
is cached by the hash of its source and flags under
``build/repro_torch_kernels/`` at the root of the checkout
(``REPRO_TORCH_BUILD`` overrides the directory), so a second compile of the
same program loads without calling ``nvcc``.  Several sources build in
parallel through :func:`build_many`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}

#: ``nvcc`` processes started (sources that were not cached yet)
runs = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str, tag: str = "stencil") -> Path:
    h = hashlib.sha256((source + "\0" + " ".join(NVCC_FLAGS)).encode())
    return build_dir() / f"{tag}_{h.hexdigest()[:16]}.so"


def toolchain() -> list:
    """What a built kernel depends on besides its source, as key parts:
    the torch and CUDA versions and the nvcc flags."""
    return [f"torch={torch.__version__}", f"cuda={torch.version.cuda}",
            "nvcc=" + " ".join(NVCC_FLAGS)]


def _start(source: str, tag: str):
    """Write the source and start ``nvcc`` on it; None when cached."""
    global runs
    so = library_path(source, tag)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    cu = so.with_suffix(".cu")
    cu.write_text(source)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    runs += 1
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return so, tmp, proc


def _finish(job) -> None:
    so, tmp, proc = job
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"{so.with_suffix('.cu')}:\n{out[-4000:]}")
    os.replace(tmp, so)


def build_many(sources, tag="stencil") -> list:
    """Compile every source not yet cached, all ``nvcc`` processes running
    at once; returns the library paths in order.  ``tag`` names the
    libraries: one tag for all, or one per source."""
    sources = list(sources)
    tags = [tag] * len(sources) if isinstance(tag, str) else list(tag)
    if len(tags) != len(sources):
        raise ValueError(f"{len(tags)} tags for {len(sources)} sources")
    jobs = [_start(s, t) for s, t in dict.fromkeys(zip(sources, tags))]
    errors = []
    for job in jobs:
        if job is None:
            continue
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s, t) for s, t in zip(sources, tags)]


def load(source: str, tag: str = "stencil") -> ctypes.CDLL:
    """The loaded library of ``source``, building it on first use."""
    so = build_many([source], tag)[0]
    lib = _LOADED.get(so)
    if lib is None:
        lib = _LOADED[so] = ctypes.CDLL(str(so))
    return lib


def ptxas_report(source: str, tag: str = "stencil") -> str:
    """What ``-Xptxas -v`` said about each kernel of a built source
    (registers, shared memory, spills)."""
    log = library_path(source, tag).with_suffix(".log")
    return log.read_text() if log.exists() else ""
