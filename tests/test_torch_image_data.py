"""The port's image data and the report's image grids against the JAX
package on the CPU: synthetic_digits bit for bit, MNISTDataModule on a gzip
IDX pair the test writes and on the synthetic fallback, both CelebA modules
on PNG folders written with PIL, split_dataset, split_batch,
crop_scaled_pair, _box_resize, make_data_module; img_to_png_base64 decoded
with PIL against the JAX one pixel for pixel, and add_image_grid. All
comparisons are exact: the modules are the same numpy.
"""
import base64
import gzip
import io
import struct

import numpy as np
import pytest
import torch

from generative_audio_tpu.data import image_data as jax_data
from generative_audio_tpu.utils import report as jax_report
from generative_audio_torch.data import image_data
from generative_audio_torch.utils import report

torch.set_num_threads(2)


def _items(dataset):
    """Each item as a tuple of arrays (a pair dataset's items are pairs)."""
    return [tuple(np.asarray(a) for a in item) if isinstance(item, tuple)
            else (np.asarray(item),) for item in
            (dataset[i] for i in range(len(dataset)))]


def _same_sets(dm, jdm):
    for name in ("train_set", "valid_set", "test_set"):
        got, want = _items(getattr(dm, name)), _items(getattr(jdm, name))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert len(a) == len(b)
            for a_, b_ in zip(a, b):
                assert a_.dtype == b_.dtype and np.array_equal(a_, b_)


@pytest.mark.parametrize("n,seed", [(6, 0), (5, 7)])
def test_synthetic_digits_bit_equal(n, seed):
    got = image_data.synthetic_digits(n, seed=seed)
    want = jax_data.synthetic_digits(n, seed=seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 1, 28, 28)
    assert np.array_equal(got, want)
    assert got.max() > 0.5


def _write_idx(path, array):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("with_test", [True, False])
def test_mnist_module_on_idx_files(tmp_path, with_test):
    rng = np.random.default_rng(1)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    _write_idx(raw / "train-images-idx3-ubyte.gz",
               rng.integers(0, 256, (40, 28, 28)))
    if with_test:
        _write_idx(raw / "t10k-images-idx3-ubyte.gz",
                   rng.integers(0, 256, (12, 28, 28)))
    kw = dict(data_folder=str(tmp_path), n_valid=8)
    dm, jdm = image_data.MNISTDataModule(**kw), jax_data.MNISTDataModule(**kw)
    assert len(dm.train_set) == 32 and len(dm.valid_set) == 8
    _same_sets(dm, jdm)


@pytest.mark.parametrize("kw", [dict(n_valid=16, n_synthetic=64),
                                dict(n_valid=0, n_synthetic=24, seed=3),
                                dict(n_valid=4, n_synthetic=16,
                                     rand_valid=False)])
def test_mnist_module_synthetic_fallback(kw):
    dm, jdm = image_data.MNISTDataModule(**kw), jax_data.MNISTDataModule(**kw)
    assert dm.shape == (1, 28, 28) and (dm.mean, dm.std) == (0.5, 0.2)
    _same_sets(dm, jdm)


def _pngs(directory, n, size, seed):
    from PIL import Image
    directory.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = (rng.uniform(size=(size, size, 3)) * 255).astype("uint8")
        Image.fromarray(arr).save(directory / f"{i}.png")


@pytest.mark.parametrize("img_size", [8, 6])
def test_celeba_hq_module(tmp_path, img_size):
    for i, split in enumerate(("train", "valid", "test")):
        _pngs(tmp_path / "CelebAMask-HQ-256" / split, 3, 16, seed=i)
    kw = dict(img_size=img_size, data_folder=tmp_path)
    dm = image_data.CelebAHQ256DataModule(store_dataset=True, **kw)
    jdm = jax_data.CelebAHQ256DataModule(**kw)
    assert dm.shape == (3, img_size, img_size)
    assert dm.train_set[0].shape == (3, img_size, img_size)
    _same_sets(dm, jdm)
    with pytest.raises(FileNotFoundError):
        image_data.CelebAHQ256DataModule()


def test_celeba_srflow_module(tmp_path):
    _pngs(tmp_path / "CelebA_SRFlow" / "GT", 4, 16, seed=1)
    _pngs(tmp_path / "CelebA_SRFlow" / "x8", 4, 2, seed=2)
    kw = dict(data_folder=tmp_path, scale=8, n_valid=1)
    dm = image_data.CelebASRFlowDataModule(**kw)
    jdm = jax_data.CelebASRFlowDataModule(**kw)
    hr, lr = dm.train_set[0]
    assert hr.shape == (3, 16, 16) and lr.shape == (3, 2, 2)
    _same_sets(dm, jdm)


def test_read_image_names_missing_decoders(tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_decoders(name, *args, **kwargs):
        if name.split(".")[0] in ("PIL", "matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(ImportError, match="PIL or matplotlib"):
        image_data._read_image(tmp_path / "x.png")


def test_split_dataset_batch_and_crop():
    data = list(np.arange(10))
    for rand in (True, False):
        a, b = image_data.split_dataset(data, 3, rand=rand)
        ja, jb = jax_data.split_dataset(data, 3, rand=rand)
        assert [int(x[0]) for x in _items(a)] == [int(x[0]) for x in
                                                  _items(ja)]
        assert [int(x[0]) for x in _items(b)] == [int(x[0]) for x in
                                                  _items(jb)]
    batch = (np.arange(8).reshape(8, 1), np.arange(24).reshape(8, 3))
    for n in (2, 3):
        got, want = image_data.split_batch(batch, n), \
            jax_data.split_batch(batch, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for g_, w_ in zip(g, w):
                assert np.array_equal(g_, w_)
    hr = np.arange(3 * 16 * 16, dtype=np.float32).reshape(3, 16, 16)
    lr = hr[:, ::2, ::2]
    for method in ("center", "rand"):
        got = image_data.crop_scaled_pair(hr, lr, 8, method,
                                          rng=np.random.default_rng(4))
        want = jax_data.crop_scaled_pair(hr, lr, 8, method,
                                         rng=np.random.default_rng(4))
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    with pytest.raises(ValueError):
        image_data.crop_scaled_pair(hr, lr, 8, "corner")


@pytest.mark.parametrize("shape,size", [((3, 16, 16), 8), ((3, 16, 12), 5),
                                        ((1, 4, 4), 4)])
def test_box_resize(shape, size):
    img = np.random.default_rng(5).uniform(size=shape).astype(np.float32)
    assert np.array_equal(image_data._box_resize(img, size),
                          jax_data._box_resize(img, size))


def test_make_data_module():
    dm = image_data.make_data_module("mnist", n_valid=4, n_synthetic=12)
    assert isinstance(dm, image_data.MNISTDataModule)
    with pytest.raises(ValueError, match="Unsupported dataset"):
        image_data.make_data_module("cifar")


def _decode(b64):
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return img.mode, np.asarray(img)


@pytest.mark.parametrize("shape", [(1, 9, 7), (3, 5, 6), (4, 4)])
def test_png_matches_jax_pixel_for_pixel(shape):
    """Gray for one channel, RGB for three, values clipped to [0, 1]."""
    img = np.random.default_rng(6).uniform(-0.2, 1.2, shape).astype(
        np.float32)
    got, want = _decode(report.img_to_png_base64(img)), \
        _decode(jax_report.img_to_png_base64(img))
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])


def test_add_image_grid(tmp_path):
    imgs = np.random.default_rng(7).uniform(size=(5, 1, 6, 6)).astype(
        np.float32)
    rep = report.HTMLReport("grids")
    rep.add_image_grid("samples", imgs, nrow=3)
    text = rep.write(tmp_path / "r.html").read_text()
    b64 = text.split('data:image/png;base64,')[1].split('"')[0]
    mode, pixels = _decode(b64)
    grid = report.imgs_to_grid(imgs, nrow=3)
    assert mode == "L" and pixels.shape == grid.shape[1:]
    assert np.array_equal(pixels, (np.clip(grid[0], 0, 1) * 255).astype(
        np.uint8))
    assert "<h2>samples</h2>" in text
