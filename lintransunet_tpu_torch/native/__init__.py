"""ctypes bindings for the native preprocessing core (``preprocess.cc``; the
port's own copy of ``lintransunet_tpu/native``).

Host preprocessing, not a device kernel. The library is built by g++ the
first time it is asked for (``AVAILABLE`` or any function below), into
``lintransunet_tpu_torch/_build/libpreprocess-<hash>.so`` (git-ignored;
the hash covers the source, the flags and the host CPU's ISA flags, since
the build targets ``-march=native``, and a build writes a temporary name
that is renamed into place). Where no compiler builds it, every
function takes its numpy fallback: ``AVAILABLE`` says which path runs.
``hu_window_normalize``'s fallback computes the library's f32 arithmetic,
``(clip(x) - mean) * (1 / std)``, so both paths give the same bits.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cc"
_BUILD = _SRC.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False


def _host_cpu() -> bytes:
    """The host's ISA flags: ``-march=native`` code runs only where they match."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return platform.machine().encode()


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode() + _host_cpu())
    return _BUILD / f"libpreprocess-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def _load():
    """The ctypes library, built on first use; None where it cannot be."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64, u64, f32, f64, i32 = (ctypes.c_int64, ctypes.c_uint64,
                               ctypes.c_float, ctypes.c_double, ctypes.c_int)
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pu = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.hu_window_normalize.argtypes = [pf, i64, f32, f32, f32, f32]
    lib.hu_window_normalize.restype = None
    lib.scale_intensity_range.argtypes = [pf, i64, f32, f32, f32, f32, i32]
    lib.scale_intensity_range.restype = None
    lib.crop3d_f32.argtypes = [pf] + [i64] * 9 + [pf]
    lib.crop3d_f32.restype = None
    lib.crop3d_u8.argtypes = [pu] + [i64] * 9 + [pu]
    lib.crop3d_u8.restype = None
    lib.sample_crop_centers.argtypes = ([pu] + [i64] * 6 + [f64, f64, i64, u64, pi])
    lib.sample_crop_centers.restype = i32
    _lib = lib
    return lib


def __getattr__(name):
    # AVAILABLE is computed at first use, not at import: it builds the library
    if name == "AVAILABLE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def hu_window_normalize(img: np.ndarray, low: float, high: float,
                        mean: float, std: float) -> np.ndarray:
    """HU window + standardise into a new float32 array."""
    lib = _load()
    if lib is None:
        return hu_window_normalize_numpy(img, low, high, mean, std)
    out = np.ascontiguousarray(img, np.float32)
    if out is img:
        out = img.copy()
    lib.hu_window_normalize(out, out.size, low, high, mean, 1.0 / std)
    return out


def hu_window_normalize_numpy(img: np.ndarray, low: float, high: float,
                              mean: float, std: float) -> np.ndarray:
    """``hu_window_normalize``'s numpy fallback: the library's f32 arithmetic."""
    clipped = np.clip(np.asarray(img, np.float32), np.float32(low), np.float32(high))
    return (clipped - np.float32(mean)) * np.float32(1.0 / std)


def crop3d(volume: np.ndarray, start, size) -> np.ndarray:
    """The (sh, sw, sd) crop at ``start`` of an (H, W, D) volume, which must
    lie inside it (numpy slicing as the fallback and for dtypes other than
    float32 and uint8)."""
    x, y, z = (int(v) for v in start)
    sh, sw, sd = (int(v) for v in size)
    if min(x, y, z, sh, sw, sd) < 0 or any(
            a + s > v for a, s, v in zip((x, y, z), (sh, sw, sd), volume.shape)):
        raise ValueError(f"crop at {tuple(start)} of {tuple(size)} leaves the "
                         f"volume {volume.shape}")
    lib = _load()
    if lib is None or volume.dtype not in (np.float32, np.uint8):
        return np.ascontiguousarray(volume[x:x + sh, y:y + sw, z:z + sd])
    volume = np.ascontiguousarray(volume)
    out = np.empty((sh, sw, sd), volume.dtype)
    crop = lib.crop3d_f32 if volume.dtype == np.float32 else lib.crop3d_u8
    crop(volume, *volume.shape, x, y, z, sh, sw, sd, out)
    return out


def sample_crop_centers(label: np.ndarray, size, pos: float, neg: float,
                        n_samples: int, seed: int):
    """Pos/neg-biased crop origins, (n_samples, 3) int64; None without the
    library (this one has no numpy fallback, as in the JAX package)."""
    lib = _load()
    if lib is None:
        return None
    label = np.ascontiguousarray(label, np.uint8)
    out = np.empty((n_samples, 3), np.int64)
    rc = lib.sample_crop_centers(
        label, *label.shape, *(int(s) for s in size),
        float(pos), float(neg), int(n_samples),
        np.uint64(seed % (2 ** 64)), out)
    if rc != 0:
        return None
    return out
