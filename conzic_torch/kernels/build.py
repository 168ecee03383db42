"""Build and load the port's CUDA kernels.

Each source in ``conzic_torch/csrc/*.cu`` is compiled on its own by ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``.
The libraries go to ``build/conzic_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one is reused. Building is started at first use; every source
not yet built is compiled at once, one ``nvcc`` process each.

Nothing here runs when the module is imported: the CPU tests import every
module of the package on machines that have no CUDA compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "conzic_torch"
SOURCES: Tuple[str, ...] = ("layer_norm", "masked_attention",
                            "attention_with_out", "attention_block",
                            "quick_gelu", "dot_product_attention")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of the kernel's launches
    that ``chip_smoke.py`` reads. Under a lock: a mesh runs its replicas on
    threads of one process."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: keyed by the
    source, every shared header and the compiler flags."""
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    todo = [(n, library_path(n)) for n in SOURCES]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.conzic_error_string.argtypes = [ctypes.c_int]
        lib.conzic_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.conzic_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]
