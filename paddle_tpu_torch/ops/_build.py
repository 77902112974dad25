"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/paddle_tpu_torch/`` under the repository root (ignored by git),
named by a hash of the source, every header under ``csrc/`` and the
flags, so an unchanged source is built once per checkout and a changed
shared header rebuilds every kernel.  Nothing is built or loaded at
import: the first launch on a CUDA tensor does it.  `build_all` starts
one ``nvcc`` per source at once, for a run that needs several.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
# compiler report (registers, shared memory, spills) of each build
build_logs = {}


def find_nvcc():
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels are built from source at "
        "first use")


def library_path(name):
    """Where `name`'s library lives for the current source, the headers
    under ``csrc/`` (any of which the source may include) and the
    flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted((*CSRC_DIR.glob("*.cuh"), *CSRC_DIR.glob("*.h"))):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names):
    """Compile ``csrc/<name>.cu`` for every name whose library is not
    built yet, one ``nvcc`` process per source, all started together;
    returns the library paths in order.  Safe to call from several
    processes: each writes a private temporary and renames it into
    place."""
    outs = [library_path(n) for n in names]
    todo = [(n, out) for n, out in zip(names, outs) if not out.is_file()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            build_logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {name}.cu (exit "
                              f"{proc.returncode}):\n{build_logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path."""
    return build_all([name])[0]


def load(name):
    """The loaded ctypes library for `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def loaded(name):
    """Whether `name`'s library has been loaded in this process."""
    with _lock:
        return name in _libs
