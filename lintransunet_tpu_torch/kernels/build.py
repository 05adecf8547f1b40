"""nvcc build of ``csrc/<name>.cu`` into a shared library, loaded with ctypes.

The sources have a plain C interface and include no PyTorch header, so a
build takes seconds. The library lands in ``_build/lib<name>-<hash>.so``;
the hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited kernel or header is rebuilt and a stale library is
never loaded. A build writes to a temporary name and renames it into
place, so concurrent first uses cannot load a half-written file. A failed
build raises with nvcc's output: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of each library's entry points: name -> (restype, argtypes).
SIGNATURES = {
    "linear_attention": {
        "lta_forward": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "lta_num_splits": (_I, [_I]),
        "lta_backward": (_I, [_P] * 12 + [_I, _I, _I, _I, _P]),
        "lta_state_floats": (_I, []),
    },
    "conv_unit": {
        "cu_forward": (_I, [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
        "cu_num_tiles": (_I, [_I, _I, _I]),
    },
    "fused_stack": {
        "fst_forward": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P]),
        "fst_num_tiles": (_I, [_I, _I]),
    },
}

_loaded = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of ``name``, or '' if it has not been built in this checkout."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_libraries(*names: str) -> None:
    """Build every named library that is not built yet, one nvcc process
    per source, all started together; raise with nvcc's output if any
    fails."""
    pending = []
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in pending:
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n{output}")
            continue
        so.with_suffix(".log").write_text(output)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    if name in _loaded:
        return _loaded[name]
    build_libraries(name)
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[name] = lib
    return lib
