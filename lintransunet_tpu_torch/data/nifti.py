"""First-party NIfTI-1 reader (pure numpy, no nibabel dependency; the port's
own copy of ``lintransunet_tpu/data/nifti.py``).

The reference ingests ``.nii`` volumes through MONAI ``LoadImaged``
(dataset/CT_pancreas_monai.py:37-40), which wraps nibabel. This image has no
nibabel, so the cached MONAI-equivalent pipeline reads NIfTI-1 natively:
fixed 348-byte header (both endiannesses), optional gzip container,
``scl_slope``/``scl_inter`` intensity scaling, and the affine from the sform
rows when ``sform_code > 0``, else the qform quaternion, else a pixdim
diagonal — the same precedence nibabel applies.

Returned arrays are indexed ``[i, j, k]`` (first file axis slowest varying
in memory after the Fortran-order reshape, matching ``nibabel.get_fdata``),
and ``affine @ [i, j, k, 1]`` gives world RAS+ millimetres.
"""

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
}

HEADER_SIZE = 348


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _quaternion_affine(hdr_pixdim, b, c, d, ox, oy, oz) -> np.ndarray:
    """qform rotation per the NIfTI-1 spec (quatern_{b,c,d} + qfac)."""
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if hdr_pixdim[0] < 0 else 1.0
    scales = np.array([hdr_pixdim[1], hdr_pixdim[2], hdr_pixdim[3] * qfac])
    affine = np.eye(4)
    affine[:3, :3] = rot * scales[None, :]
    affine[:3, 3] = (ox, oy, oz)
    return affine


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .nii / .nii.gz volume -> (data, affine 4x4 float64).

    Only the 3D image case the reference pipeline consumes is supported;
    trailing singleton dims are squeezed. ``scl_slope``/``scl_inter`` are
    applied when set (slope != 0 and not the identity), promoting to f32.
    """
    raw = _read_bytes(path)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    for endian in ("<", ">"):
        (sizeof_hdr,) = struct.unpack_from(endian + "i", raw, 0)
        if sizeof_hdr == HEADER_SIZE:
            break
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr != 348)")

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    (datatype, bitpix) = struct.unpack_from(endian + "2h", raw, 70)
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", raw, 108)
    (scl_slope, scl_inter) = struct.unpack_from(endian + "2f", raw, 112)
    (qform_code, sform_code) = struct.unpack_from(endian + "2h", raw, 252)
    quatern = struct.unpack_from(endian + "6f", raw, 256)
    srow = np.array(struct.unpack_from(endian + "12f", raw, 280),
                    np.float64).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    ndim = int(dim[0])
    shape = tuple(int(s) for s in dim[1:1 + max(ndim, 3)])
    count = int(np.prod(shape))

    offset = int(vox_offset) if magic[:3] == b"n+1" else 0
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    # NIfTI stores the first axis fastest: Fortran-order reshape gives the
    # conventional [i, j, k] indexing (== nibabel).
    data = data.reshape(shape, order="F")
    data = np.squeeze(data, axis=tuple(range(3, data.ndim))) \
        if data.ndim > 3 else data

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        data = np.asarray(data.astype(data.dtype.newbyteorder("=")))

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _quaternion_affine(pixdim, *quatern)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return np.ascontiguousarray(data), affine


def write_nifti(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    """Minimal NIfTI-1 writer (sform affine, no scaling) — test fixture and
    export utility for interoperating with the reference's MONAI pipeline."""
    data = np.asarray(data)
    code = {np.dtype(v): k for k, v in _DTYPES.items()}.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(HEADER_SIZE + 4)  # +4: the extension flag bytes
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    spacing = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform off, sform on
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, np.float64)[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
