"""nvcc build of ``csrc/<name>.cu`` into a shared library, loaded with ctypes.

The sources have a plain C interface and include no PyTorch header, so a
build takes seconds. The library lands in ``_build/lib<name>-<hash>.so``;
the hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited kernel or header is rebuilt and a stale library is
never loaded. Extra nvcc flags (a ``-D`` variant, such as the clock64
phase split of ``tools/profile_stack.py``) build a library of their own
beside the plain one. A build writes to a temporary name and renames it into
place, so concurrent first uses cannot load a half-written file. A failed
build raises with nvcc's output: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of each library's entry points: name -> (restype, argtypes).
SIGNATURES = {
    "linear_attention": {
        "lta_call": (_I, [_P, _P]),
        "lta_scratch_floats": (_L, [_I, _I, _I]),
    },
    "conv_unit": {
        "cu_forward": (_I, [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P,
                            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
        "cu_num_partials": (_I, [_I] * 9),
    },
    "conv_wgrad": {
        "cw_depthwise": (_I, [_P, _P, _P, _P, _P, _I, _P]),
    },
    "conv_narrow": {
        "cn_forward": (_I, [_P, _P, _I, _P, _P, _P, _P, _P]),
    },
    "conv_depthwise": {
        "cd_forward": (_I, [_P, _P, _I, _P, _P, _P, _P]),
    },
    "fused_stack": {
        "fst_forward": (_I, [_P] * 10 + [_I] * 6 + [_P]),
        "fst_num_tiles": (_I, [_I, _I]),
        "fst_occupancy": (_I, [_I, _I, _P]),
    },
    "probe_taps": {
        "pt_tap_sum": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P]),
        "pt_inner_step": (_I, [_P, _P, _P, _I, _I, _I, _P, _P]),
    },
    "probe_conv": {
        "pc_forward": (_I, [_P, _P, _P, _P] + [_I] * 7 + [_P]),
        "pc_wgmma_product": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    },
    "probe_stats": {
        "ps_lane_sums": (_I, [_P, _P, _I, _I, _I, _I, _I, _F, _P]),
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


def _library_path(name: str, flags: Tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str, flags: Tuple[str, ...] = ()) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of ``name``, or '' if it has not been built in this checkout."""
    log = _library_path(name, flags).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_libraries(*names: str, flags: Tuple[str, ...] = ()) -> None:
    """Build every named library that is not built yet, one nvcc process
    per source, all started together, with ``flags`` after the usual ones;
    raise with nvcc's output if any fails."""
    pending = []
    for name in names:
        so = _library_path(name, flags)
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def load(name: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use. The
    wrappers call the plain build; a build with extra ``flags`` is kept
    apart, and a caller that wants the wrappers to use it puts it into
    ``_loaded[name]``."""
    key = (name, tuple(flags)) if flags else name
    if key in _loaded:
        return _loaded[key]
    build_libraries(name, flags=tuple(flags))
    lib = ctypes.CDLL(str(_library_path(name, tuple(flags))))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[key] = lib
    return lib
