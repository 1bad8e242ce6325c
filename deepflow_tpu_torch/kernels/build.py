"""Build and load the port's CUDA kernels.

Each `kernels/<name>.cu` compiles at first use, with the CUDA toolkit's
`nvcc` alone, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o deepflow_tpu_torch/_build/lib<name>-<hash>.so <name>.cu

The output lands in `deepflow_tpu_torch/_build/` (git-ignored), keyed by
a hash of the source and the flags, and is loaded with `ctypes`. The
launchers take raw device pointers and the current stream, and return
`cudaGetLastError()` after the launch; `check_launch` raises on a
nonzero code. A missing `nvcc` or a failed build raises: nothing falls
back to the plain PyTorch versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
#: seconds each source took to compile in this process (0.0 = cached)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """The toolkit's nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the port's CUDA kernels build from source at first use"
    )


def library_path(name: str) -> Path:
    src = KERNEL_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, nvcc: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names) -> None:
    """Compile every named source that has no up-to-date library yet,
    one nvcc per source, all started together. Raises on any failure."""
    todo = [n for n in names if not library_path(n).exists()]
    for n in names:
        build_seconds.setdefault(n, 0.0)
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {n: _start_build(n, nvcc) for n in todo}
    errors = []
    for n, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def all_sources() -> list[str]:
    return sorted(p.stem for p in KERNEL_DIR.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `kernels/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error. Every kernel source
    exports `const char* df_error_string(int)` for the message."""
    if code != 0:
        fn = lib.df_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        msg = fn(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}): {msg}")
