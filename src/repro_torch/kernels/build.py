"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``.  The build happens at first use,
never at import: all missing libraries are compiled at once, one ``nvcc``
process per source started together.  Outputs go to ``build/repro_torch/``
at the root of the checkout, named by a hash of the sources and flags, so
an edited kernel is rebuilt and an unchanged one is not.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after the launch; :func:`check` raises on a
non-zero code.  Each wrapper adds one to :data:`LAUNCHES` under its kernel's
name where it launches the kernel, and nowhere else, so a run can show
which kernels its path went through.  A kernel with more than one path
inside (``flash_attention``: its float32 kernel, its bf16 kernel fed by TMA,
or by plain loads) also adds one to :data:`PATHS` under the path taken.

A wrapper called while a CUDA graph is being captured records its launch
in the graph instead of launching it; the graph launches it at each
replay.  So a capture made inside :func:`captured_launches` takes its
records off the counts, and the code that replays the graph adds them back
once a replay (:func:`count_replay`): the counts say what ran on the card.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "BUILD_DIR",
    "LAUNCHES",
    "PATHS",
    "SOURCES",
    "build_all",
    "captured_launches",
    "check",
    "check_tensor",
    "compile_command",
    "count_replay",
    "library",
    "log_path",
    "reset_launch_counts",
    "stream_of",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("prefix_stats", "sampled_agg", "quantile_select", "tree_qmc", "sobol",
           "flash_attention", "flash_attention_bwd")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches by kernel name (see the module docstring).
LAUNCHES: collections.Counter = collections.Counter()
#: Launches by ``"<kernel>.<path>"`` (see the module docstring).
PATHS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    PATHS.clear()


@contextlib.contextmanager
def captured_launches():
    """Around a graph capture: yields a counter that holds, on exit, the
    launches the capture recorded (kernels and ``<kernel>.<path>`` keys), and
    takes them off :data:`LAUNCHES` and :data:`PATHS`."""
    before = LAUNCHES.copy(), PATHS.copy()
    recorded: collections.Counter = collections.Counter()
    try:
        yield recorded
    finally:
        for counts, was in zip((LAUNCHES, PATHS), before):
            recorded.update(counts - was)
            counts.clear()
            counts.update(was)


def count_replay(recorded: collections.Counter) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    for key, n in recorded.items():
        (PATHS if "." in key else LAUNCHES)[key] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "repro_torch: nvcc not found (looked in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin and PATH); the CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``) for the library that
    :func:`library` loads for ``name``: it bears the library's hash."""
    return _lib_path(name).with_suffix(".log")


def compile_command(source: Path, out: Path) -> list[str]:
    """The ``nvcc`` command that builds ``source`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(source)]


def build_all() -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns the wall seconds of the build (0.0 when nothing was missing)
    under ``"total"``, and writes each compiler's output (``-Xptxas -v``
    registers and spills) next to its library, at :func:`log_path`.
    """
    with _lock:
        missing = [(n, _lib_path(n)) for n in SOURCES if not _lib_path(n).exists()]
        if not missing:
            return {"total": 0.0}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name, path in missing:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs.append((name, path, tmp, subprocess.Popen(
                compile_command(CSRC / f"{name}.cu", tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for name, path, tmp, proc in procs:
            log, _ = proc.communicate()
            path.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("repro_torch: nvcc failed for " + "\n".join(failed))
        return {"total": time.perf_counter() - t0}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"repro_torch: kernel {name} failed to launch (cudaError {err})")


def check_tensor(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    """A kernel input must be a contiguous CUDA tensor of the given type and rank."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """``(device index, current stream handle)`` for launching on ``t``'s card."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
