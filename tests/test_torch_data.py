"""The port's data pipeline and native preprocessing core against the JAX
package's, bit for bit (``np.testing.assert_array_equal``): the same arrays
and the same numpy Generators give the same arrays. Both packages' native
libraries are built by g++ here; the port's numpy fallback (the library
switched off) gives the library's bits too."""

import json
import os
import struct

import numpy as np
import pytest

from lintransunet_tpu import data as jax_data
from lintransunet_tpu import native as jax_native
from lintransunet_tpu.data import nifti as jax_nifti
from lintransunet_tpu.data import transforms as JT
from lintransunet_tpu_torch import data
from lintransunet_tpu_torch import native
from lintransunet_tpu_torch.data import nifti
from lintransunet_tpu_torch.data import transforms as T


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Synthetic .npy CT volumes, (D, H, W) with a foreground blob (class 2
    inside it on every other volume), as ``tests/test_data.py`` makes them."""
    root = tmp_path_factory.mktemp("ct")
    os.makedirs(root / "image")
    os.makedirs(root / "label")
    rng = np.random.default_rng(0)
    for i in range(4):
        d = 12 + 2 * i
        img = rng.normal(40.0, 60.0, (d, 32, 32)).astype(np.float32)
        lbl = np.zeros((d, 32, 32), np.uint8)
        lbl[d // 3:d // 2, 10:20, 12:22] = 1
        if i % 2 == 0:
            lbl[d // 2:d // 2 + 2, 14:17, 14:17] = 2
        np.save(root / "image" / f"{i:04d}.npy", img)
        np.save(root / "label" / f"{i:04d}.npy", lbl)
    return str(root)


def _same(got, want):
    """Equal structure, dtypes and bits (tuples and lists of arrays too)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------- NIfTI

def _affine_lsp(spacing=(0.7, 2.5, 0.9)):
    aff = np.zeros((4, 4))
    aff[0, 0] = -spacing[0]
    aff[2, 1] = spacing[1]
    aff[1, 2] = -spacing[2]
    aff[:3, 3] = (10.0, -5.0, 3.0)
    aff[3, 3] = 1.0
    return aff


def _big_endian_copy(src, dst):
    """A little-endian NIfTI-1 file of ``write_nifti`` rewritten big-endian:
    every header field and the payload byte-swapped."""
    raw = open(src, "rb").read()
    fields = [(0, "i"), (40, "8h"), (70, "2h"), (76, "8f"), (108, "f"), (112, "2f"),
              (252, "2h"), (256, "6f"), (280, "12f")]
    out = bytearray(raw)
    for offset, fmt in fields:
        struct.pack_into(">" + fmt, out, offset, *struct.unpack_from("<" + fmt, raw, offset))
    (datatype,) = struct.unpack_from("<h", raw, 70)
    dtype = np.dtype(nifti._DTYPES[datatype])
    payload = np.frombuffer(raw, dtype.newbyteorder("<"), offset=nifti.HEADER_SIZE + 4)
    out[nifti.HEADER_SIZE + 4:] = payload.astype(dtype.newbyteorder(">")).tobytes()
    open(dst, "wb").write(bytes(out))


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("name", ["v.nii", "v.nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_cross_package(tmp_path, endian, name, writer):
    """A volume written by one package reads the same in both (data and
    affine), in either byte order; both writers write the same bytes."""
    rng = np.random.default_rng(3)
    vol = rng.normal(50.0, 30.0, (9, 7, 5)).astype(np.float32)
    path = str(tmp_path / name)
    (nifti if writer == "port" else jax_nifti).write_nifti(path, vol, _affine_lsp())
    other = str(tmp_path / f"other_{name}")
    (jax_nifti if writer == "port" else nifti).write_nifti(other, vol, _affine_lsp())
    if not name.endswith(".gz"):  # gzip stamps the time into its header
        assert open(path, "rb").read() == open(other, "rb").read()
    if endian == ">":
        plain = str(tmp_path / "plain.nii")
        nifti.write_nifti(plain, vol, _affine_lsp())
        path = str(tmp_path / "big.nii")
        _big_endian_copy(plain, path)
    got, want = nifti.read_nifti(path), jax_nifti.read_nifti(path)
    _same(got, want)
    np.testing.assert_array_equal(got[0], vol)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_nifti_qform_and_scaling(tmp_path, endian):
    """The qform branch (a rotating quaternion, qfac -1) and scl_slope /
    scl_inter read the same in both packages."""
    vol = np.arange(-30, 30, dtype=np.int16).reshape(3, 4, 5)
    path = str(tmp_path / "q.nii")
    nifti.write_nifti(path, vol, np.diag([1.5, 2.0, 3.0, 1.0]))
    raw = bytearray(open(path, "rb").read())
    struct.pack_into("<2h", raw, 252, 1, 0)                    # qform on, sform off
    struct.pack_into("<6f", raw, 256, 0.1, -0.2, 0.3, 4, 5, 6)  # b, c, d, offsets
    struct.pack_into("<f", raw, 76, -1.0)                       # qfac
    struct.pack_into("<2f", raw, 112, 2.0, -10.0)               # slope, inter
    open(path, "wb").write(bytes(raw))
    if endian == ">":
        big = str(tmp_path / "qb.nii")
        _big_endian_copy(path, big)
        path = big
    got, want = nifti.read_nifti(path), jax_nifti.read_nifti(path)
    _same(got, want)
    assert got[0].dtype == np.float32
    assert not np.allclose(got[1][:3, :3], np.diag(np.diag(got[1][:3, :3])))


# ---------------------------------------------------------- transforms

def _volume(seed=0, shape=(20, 18, 10)):
    rng = np.random.default_rng(seed)
    img = rng.normal(40.0, 80.0, shape).astype(np.float32)
    lbl = np.zeros(shape, np.uint8)
    lbl[6:12, 5:11, 3:7] = 1
    return img, lbl


TRANSFORM_CASES = {
    "hu_window_normalise": lambda M, img, lbl, rng: M.hu_window_normalise(
        img, -91.0, 250.0, 86.9, 39.4),
    "scale_intensity_range": lambda M, img, lbl, rng: M.scale_intensity_range(
        img, -96.0, 215.0, -2.3, 1.8),
    "rand_crop_by_pos_neg_label": lambda M, img, lbl, rng: M.rand_crop_by_pos_neg_label(
        img, lbl, (8, 8, 4), 0.7, 0.3, 5, rng),
    "rand_crop_pads_small_volumes": lambda M, img, lbl, rng: M.rand_crop_by_pos_neg_label(
        img, lbl, (24, 8, 13), 0.7, 0.3, 3, rng),
    "rand_rotate": lambda M, img, lbl, rng: M.rand_rotate(img, lbl, np.pi / 9, rng, prob=1.0),
    "rand_adjust_contrast": lambda M, img, lbl, rng: M.rand_adjust_contrast(img, rng, prob=1.0),
    "rand_zoom_in": lambda M, img, lbl, rng: M.rand_zoom(img, lbl, rng, prob=1.0,
                                                         min_zoom=1.1, max_zoom=1.3),
    "rand_zoom_out": lambda M, img, lbl, rng: M.rand_zoom(img, lbl, rng, prob=1.0,
                                                          min_zoom=0.7, max_zoom=0.9),
    "rand_flip": lambda M, img, lbl, rng: M.rand_flip(img, lbl, rng, prob=1.0),
    "rand_rotate90": lambda M, img, lbl, rng: M.rand_rotate90(img, lbl, rng, prob=1.0),
    "default_probabilities": lambda M, img, lbl, rng: [
        M.rand_rotate(img, lbl, np.pi / 9, rng), M.rand_adjust_contrast(img, rng),
        M.rand_zoom(img, lbl, rng), M.rand_flip(img, lbl, rng), M.rand_rotate90(img, lbl, rng),
        rng.random()],
    "spacing_resample": lambda M, img, lbl, rng: M.spacing_resample(
        img, (1.0, 1.2, 2.5), (0.5, 0.5, 2.0), order=1, label=lbl),
    "affine_to_spacing_axcodes": lambda M, img, lbl, rng: M.affine_to_spacing_axcodes(
        _affine_lsp()),
    "ras_permutation": lambda M, img, lbl, rng: M.ras_permutation("LSP"),
    "orient_ras": lambda M, img, lbl, rng: M.orient_ras(img, "LSP"),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transform_matches_jax(case):
    img, lbl = _volume()
    run = TRANSFORM_CASES[case]
    got = run(T, img, lbl, np.random.default_rng(5))
    want = run(JT, img, lbl, np.random.default_rng(5))
    _same(got, want)


# ------------------------------------------------------------ datasets

def _draws(dataset, indices, seeds):
    """Items of ``dataset`` with the legacy global seed set before each (the
    datasets seed their Generator from ``np.random.randint``)."""
    out = []
    for seed in seeds:
        for i in indices:
            np.random.seed(seed)
            out.append(dataset[i])
    return out


@pytest.mark.parametrize("name", ["IdPosPanCTDataset", "MultiClassPanCTDataset"])
@pytest.mark.parametrize("is_transform", [True, False])
def test_train_dataset_matches_jax(data_root, name, is_transform):
    kw = dict(root=data_root, depth_size=4, num_samples=3, is_transform=is_transform,
              ids=[0, 1, 3], image_crop=16, seed=2)
    got = _draws(getattr(data, name)(**kw), range(3), range(4))
    want = _draws(getattr(jax_data, name)(**kw), range(3), range(4))
    _same(got, want)
    assert got[0][0].shape == (3, 16, 16, 4, 1) and got[0][1].shape == (3, 16, 16, 4)


@pytest.mark.parametrize("name", ["EvaPanCTDataset", "MultiClassEvaDataset"])
def test_eval_dataset_matches_jax(data_root, name):
    kw = dict(root=data_root, depth_size=4, ids=[1, 2])
    got = [getattr(data, name)(**kw)[i] for i in range(2)]
    want = [getattr(jax_data, name)(**kw)[i] for i in range(2)]
    _same(got, want)
    assert got[0][0].shape == (1, 32, 32, 14, 1)


@pytest.mark.parametrize("train", [True, False])
def test_cache_dataset_npy_matches_jax(data_root, train):
    cls = "CachePanDataset" if train else "EvaPanDataset"
    kw = dict(root=data_root, depth_size=4, ids=[0, 2], image_crop=16, num_workers=2, seed=1)
    if train:
        kw["num_samples"] = 2
    got = _draws(getattr(data, cls)(**kw), range(2), range(3))
    want = _draws(getattr(jax_data, cls)(**kw), range(2), range(3))
    _same(got, want)


def test_cache_dataset_nifti_matches_jax(tmp_path):
    root = tmp_path / "nii"
    os.makedirs(root / "imagesTr")
    os.makedirs(root / "labelsTr")
    rng = np.random.default_rng(11)
    for i in range(2):
        vol = rng.normal(60.0, 80.0, (10, 8, 12)).astype(np.float32)
        lbl = np.zeros_like(vol, dtype=np.uint8)
        lbl[3:6, 2:5, 4:9] = 1
        aff = _affine_lsp(spacing=(1.0, 4.0, 1.0))
        nifti.write_nifti(str(root / "imagesTr" / f"v{i}.nii.gz"), vol, aff)
        nifti.write_nifti(str(root / "labelsTr" / f"v{i}.nii.gz"), lbl, aff)
    kw = dict(root=str(root), depth_size=4, num_samples=2, image_crop=8, num_workers=1, seed=3)
    got = _draws(data.CachePanDataset(**kw), range(2), range(3))
    want = _draws(jax_data.CachePanDataset(**kw), range(2), range(3))
    _same(got, want)


# ---------------------------------------------------- split and loader

def test_split_matches_jax(tmp_path):
    for n, k, seed in ((20, 8, 0), (4, 2, 0), (13, 5, 7)):
        assert data.kfold_indices(n, k, True, seed) == jax_data.kfold_indices(n, k, True, seed)
        assert data.kfold_indices(n, k, False) == jax_data.kfold_indices(n, k, False)
    got = data.write_split_json(13, str(tmp_path / "a.json"), n_splits=5, seed=7)
    want = jax_data.write_split_json(13, str(tmp_path / "b.json"), n_splits=5, seed=7)
    assert got == want
    assert open(tmp_path / "a.json").read() == open(tmp_path / "b.json").read()
    assert data.load_fold(str(tmp_path / "a.json"), 3) == jax_data.load_fold(
        str(tmp_path / "b.json"), 3)
    assert json.load(open(tmp_path / "a.json")) == got


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_order_matches_jax(data_root, shuffle):
    """The same batches in the same order, epoch after epoch, from worker
    threads."""
    kw = dict(root=data_root, depth_size=4, ids=[0, 1, 2, 3])
    port = data.DataLoader(data.EvaPanCTDataset(**kw), batch_size=1, shuffle=shuffle,
                           num_workers=3, seed=4)
    ref = jax_data.DataLoader(jax_data.EvaPanCTDataset(**kw), batch_size=1,
                              shuffle=shuffle, num_workers=3, seed=4)
    for _ in range(2):
        got, want = list(port), list(ref)
        _same(got, want)
    depths = [img.shape[4] for img, _ in got]
    assert (depths == [12, 14, 16, 18]) == (not shuffle)


def test_loader_propagates_worker_exceptions():
    class Boom:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise ValueError("bad sample")
            return (np.zeros((2, 2), np.float32),)

    with pytest.raises(ValueError, match="bad sample"):
        list(data.DataLoader(Boom(), batch_size=1, num_workers=2))


# -------------------------------------------------------------- native

def test_native_core_is_built_into_the_build_directory():
    assert native.AVAILABLE and jax_native.AVAILABLE
    assert native._library_path().parent.name == "_build"
    assert native._library_path().exists()


@pytest.fixture
def numpy_fallback(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.AVAILABLE


@pytest.mark.parametrize("shape", [(24, 64, 64), (3, 5, 7)])
def test_native_hu_window_matches_jax_and_its_fallback(request, shape):
    img = np.random.default_rng(0).normal(40, 80, shape).astype(np.float32)
    got = native.hu_window_normalize(img, -91, 250, 86.9, 39.4)
    _same(got, jax_native.hu_window_normalize(img, -91, 250, 86.9, 39.4))
    request.getfixturevalue("numpy_fallback")
    _same(native.hu_window_normalize(img, -91, 250, 86.9, 39.4), got)
    _same(T.hu_window_normalise(img, -91, 250, 86.9, 39.4), got)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_native_crop3d_matches_jax_and_its_fallback(request, dtype):
    vol = (np.random.default_rng(1).normal(size=(30, 40, 20)) * 50).astype(dtype)
    crops = [((3, 5, 2), (16, 24, 12)), ((0, 0, 0), (8, 8, 8)), ((14, 16, 8), (16, 24, 12))]
    got = [native.crop3d(vol, start, size) for start, size in crops]
    _same(got, [jax_native.crop3d(vol, start, size) for start, size in crops])
    _same(got, [vol[x:x + a, y:y + b, z:z + c] for (x, y, z), (a, b, c) in crops])
    request.getfixturevalue("numpy_fallback")
    _same([native.crop3d(vol, start, size) for start, size in crops], got)


def test_native_crop3d_refuses_a_crop_outside_the_volume():
    vol = np.zeros((10, 10, 10), np.float32)
    for start, size in (((5, 0, 0), (6, 4, 4)), ((-1, 0, 0), (4, 4, 4)),
                        ((0, 0, 8), (4, 4, 3))):
        with pytest.raises(ValueError, match="leaves the volume"):
            native.crop3d(vol, start, size)


def test_native_sample_crop_centers_matches_jax():
    lbl = np.zeros((40, 40, 16), np.uint8)
    lbl[10:14, 10:14, 4:8] = 1
    for seed in (0, 3, 2 ** 63 + 5):
        got = native.sample_crop_centers(lbl, (16, 16, 8), 0.7, 0.3, 200, seed=seed)
        _same(got, jax_native.sample_crop_centers(lbl, (16, 16, 8), 0.7, 0.3, 200, seed=seed))
        assert got.shape == (200, 3) and (got >= 0).all()
        assert (got[:, 0] <= 24).all() and (got[:, 2] <= 8).all()


def test_native_sample_crop_centers_without_the_library(numpy_fallback):
    assert native.sample_crop_centers(np.ones((4, 4, 4), np.uint8), (2, 2, 2), 1, 1, 3, 0) is None
