"""Image datasets of the image-NPPC line (host side, numpy).

Port of generative_audio_tpu/data/image_data.py (reference
nppc/datasets.py): split_dataset (the seed-42 tail split), split_batch,
ImageFilesDataset, the caching DatasetWrapper, PairsDataset,
crop_scaled_pair, the IDX reader, synthetic_digits (bit for bit the JAX
module's), MNISTDataModule (shape (1, 28, 28), mean .5, std .2; the IDX
files where `data_folder` holds them, else synthetic digits),
CelebAHQ256DataModule and CelebASRFlowDataModule (mean .5, std .5) and
make_data_module. Items are numpy [C, H, W] float32 in [0, 1]; the trainers
stack them and move each batch to the device.

Image files decode through PIL, else matplotlib; where neither is
installed, reading one raises an ImportError that names both.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "ImageFilesDataset", "DatasetWrapper", "PairsDataset", "SubsetDataset",
    "split_dataset", "split_batch", "crop_scaled_pair", "synthetic_digits",
    "MNISTDataModule", "CelebAHQ256DataModule", "CelebASRFlowDataModule",
    "make_data_module",
]


# --------------------------------------------------------------------------
# Auxiliary dataset containers
# --------------------------------------------------------------------------
class SubsetDataset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        return self.dataset[int(self.indices[index])]


def split_dataset(dataset, split_size: int, rand: bool = True):
    """Tail split with the reference's fixed seed-42 shuffle (ref :26-37)."""
    n = len(dataset)
    indices = (np.random.RandomState(42).permutation(n) if rand
               else np.arange(n))
    return (SubsetDataset(dataset, indices[:-split_size]),
            SubsetDataset(dataset, indices[-split_size:]))


def split_batch(batch, n: int):
    """Recursive chunk along axis 0 (grad accumulation; ref :39-44)."""
    if isinstance(batch, (tuple, list)):
        return tuple(zip(*[split_batch(b, n) for b in batch]))
    return tuple(np.array_split(batch, n, axis=0))


def _read_image(path) -> np.ndarray:
    """Decode an image file to [C, H, W] float32 in [0, 1]."""
    try:
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    except ImportError:
        try:
            import matplotlib.image as mpimg
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs PIL or matplotlib, and neither is "
                f"installed") from e
        img = np.asarray(mpimg.imread(str(path)), np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if img.shape[-1] == 4:
            img = img[..., :3]
        if img.max() > 1.5:  # uint8-range decode
            img = img / 255.0
    return np.transpose(img, (2, 0, 1))


class ImageFilesDataset:
    """Sorted directory (or explicit list) of image files (ref :47-64)."""

    def __init__(self, filenames, transform=None):
        if isinstance(filenames, (str, Path)):
            root = Path(filenames)
            filenames = [root / f for f in sorted(os.listdir(root))]
        self.filenames = list(filenames)
        self.transform = transform

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        img = _read_image(self.filenames[index])
        if self.transform is not None:
            img = self.transform(img)
        return img


class DatasetWrapper:
    """Optional in-RAM cache + transform (ref :67-113)."""

    def __init__(self, dataset, store_dataset: bool = False, transform=None):
        self.dataset = dataset
        self.transform = transform
        self.stored = [None] * len(dataset) if store_dataset else None

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        if self.stored is None:
            x = self.dataset[index]
        else:
            if self.stored[index] is None:
                self.stored[index] = self.dataset[index]
            x = self.stored[index]
        if self.transform is not None:
            x = self.transform(x)
        return x


class PairsDataset:
    """Zip of datasets by index (ref :115-126)."""

    def __init__(self, *datasets, transform=None):
        self.datasets = datasets
        self.transform = transform

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, index):
        x = tuple(d[index] for d in self.datasets)
        if self.transform is not None:
            x = self.transform(x)
        return x


def crop_scaled_pair(hr_img: np.ndarray, lr_img: np.ndarray, patch_size: int,
                     method: str = "rand", rng: Optional[np.random.Generator] = None):
    """Aligned random/center crop of an (HR, LR) pair ([C,H,W]; ref :130-157)."""
    hr_w = hr_img.shape[-1]
    lr_h, lr_w = lr_img.shape[-2:]
    scale = hr_w // lr_w
    lr_patch = patch_size // scale
    if method.lower() == "rand":
        rng = rng or np.random.default_rng()
        left = int(rng.integers(0, lr_w - lr_patch + 1))
        top = int(rng.integers(0, lr_h - lr_patch + 1))
    elif method.lower() == "center":
        left = (lr_w - lr_patch) // 2
        top = (lr_h - lr_patch) // 2
    else:
        raise ValueError(f"Unsupported method: {method!r}")
    lr_out = lr_img[..., top:top + lr_patch, left:left + lr_patch]
    hr_out = hr_img[..., top * scale:(top + lr_patch) * scale,
                    left * scale:(left + lr_patch) * scale]
    return hr_out, lr_out


# --------------------------------------------------------------------------
# MNIST (IDX files or deterministic synthetic fallback)
# --------------------------------------------------------------------------
def _load_idx(path: Path) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find_idx(data_folder, stem: str) -> Optional[Path]:
    if data_folder is None:
        return None
    for sub in ("", "MNIST", "MNIST/raw", "raw"):
        for suffix in ("", ".gz"):
            p = Path(data_folder) / sub / (stem + suffix)
            if p.exists():
                return p
    return None


def synthetic_digits(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic MNIST-like 28x28 digit strokes, [N, 1, 28, 28] in [0,1].

    Procedurally rendered seven-segment-style digits with jitter/blur so the
    image NPPC toy task (denoising/inpainting on structured images) runs
    hermetically without the real MNIST files."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    #      a
    #    f   b      segment endpoints in a 28x28 box
    #      g
    #    e   c
    #      d
    segs = {
        "a": ((6, 6), (6, 21)), "b": ((6, 21), (14, 21)),
        "c": ((14, 21), (22, 21)), "d": ((22, 6), (22, 21)),
        "e": ((14, 6), (22, 6)), "f": ((6, 6), (14, 6)),
        "g": ((14, 6), (14, 21)),
    }
    digit_segs = {
        0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
        5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcdfg",
    }
    out = np.zeros((n, 1, 28, 28), np.float32)
    for i in range(n):
        digit = int(rng.integers(0, 10))
        dx, dy = rng.uniform(-2.5, 2.5, 2)
        width = rng.uniform(1.0, 1.8)
        img = np.zeros((28, 28), np.float32)
        for s in digit_segs[digit]:
            (y0, x0), (y1, x1) = segs[s]
            y0, x0, y1, x1 = y0 + dy, x0 + dx, y1 + dy, x1 + dx
            # distance from each pixel to the segment
            vy, vx = y1 - y0, x1 - x0
            t = np.clip(((yy - y0) * vy + (xx - x0) * vx)
                        / max(vy * vy + vx * vx, 1e-6), 0, 1)
            dist2 = (yy - (y0 + t * vy)) ** 2 + (xx - (x0 + t * vx)) ** 2
            img = np.maximum(img, np.exp(-dist2 / (2 * width ** 2)))
        out[i, 0] = np.clip(img, 0, 1)
    return out


class _ArrayDataset:
    def __init__(self, array: np.ndarray):
        self.array = array

    def __len__(self):
        return len(self.array)

    def __getitem__(self, index):
        return self.array[index]


class MNISTDataModule:
    """shape (1,28,28), mean 0.5, std 0.2 (ref :174-214)."""
    shape = (1, 28, 28)
    mean = 0.5
    std = 0.2

    def __init__(self, data_folder: Optional[str] = None, n_valid: int = 256,
                 rand_valid: bool = True, n_synthetic: int = 4096,
                 seed: int = 0):
        train_imgs = _find_idx(data_folder, "train-images-idx3-ubyte")
        test_imgs = _find_idx(data_folder, "t10k-images-idx3-ubyte")
        if train_imgs is not None:
            train = _load_idx(train_imgs).astype(np.float32)[:, None] / 255.0
            test = (_load_idx(test_imgs).astype(np.float32)[:, None] / 255.0
                    if test_imgs is not None else train[-1024:])
        else:
            train = synthetic_digits(n_synthetic, seed=seed)
            test = synthetic_digits(max(n_synthetic // 8, n_valid * 2),
                                    seed=seed + 1)
        train_set = _ArrayDataset(train)
        test_set = _ArrayDataset(test)
        if n_valid != 0:
            train_set, valid_set = split_dataset(train_set, n_valid,
                                                 rand=rand_valid)
        else:
            valid_set = test_set
        self.train_set, self.valid_set, self.test_set = (
            train_set, valid_set, test_set)


class CelebAHQ256DataModule:
    """Image-folder train/valid/test (ref :216-251); mean .5, std .5."""
    mean = 0.5
    std = 0.5

    def __init__(self, img_size: int = 256, data_folder: Optional[str] = None,
                 store_dataset: bool = False):
        self.img_size = img_size
        self.shape = (3, img_size, img_size)
        if data_folder is None:
            raise FileNotFoundError(
                "CelebAMask-HQ-256 requires a local data folder")
        root = Path(data_folder) / "CelebAMask-HQ-256"
        if not root.is_dir():
            root = Path(data_folder)

        def resize(img):
            return _box_resize(img, img_size)

        sets = {}
        for split in ("train", "valid", "test"):
            ds = ImageFilesDataset(root / split, transform=resize)
            sets[split] = DatasetWrapper(ds, store_dataset=store_dataset)
        self.train_set, self.valid_set, self.test_set = (
            sets["train"], sets["valid"], sets["test"])


class CelebASRFlowDataModule:
    """Aligned HR (GT/) + LR (x{scale}/) pairs (ref :253-292)."""
    mean = 0.5
    std = 0.5

    def __init__(self, data_folder: Optional[str] = None, scale: int = 8,
                 n_valid: int = 256, rand_valid: bool = True,
                 store_dataset: bool = False):
        self.img_size = 160
        self.shape = (3, self.img_size, self.img_size)
        if data_folder is None:
            raise FileNotFoundError("CelebA_SRFlow requires a data folder")
        root = Path(data_folder) / "CelebA_SRFlow"
        if not root.is_dir():
            root = Path(data_folder)
        names = sorted(os.listdir(root / "GT"))
        train_set = PairsDataset(
            ImageFilesDataset([root / "GT" / n for n in names]),
            ImageFilesDataset([root / f"x{scale}" / n for n in names]))
        if store_dataset:
            train_set = DatasetWrapper(train_set, store_dataset=True)
        if n_valid != 0:
            train_set, valid_set = split_dataset(train_set, n_valid,
                                                 rand=rand_valid)
        else:
            valid_set = train_set
        self.train_set, self.valid_set, self.test_set = (
            train_set, valid_set, valid_set)


def _box_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Box-filter resize of [C, H, W] to size x size (integer factors only
    downscale exactly; otherwise nearest)."""
    c, h, w = img.shape
    if h == size and w == size:
        return img
    if h % size == 0 and w % size == 0:
        fh, fw = h // size, w // size
        return img.reshape(c, size, fh, size, fw).mean(axis=(2, 4))
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return img[:, ys][:, :, xs]


def make_data_module(dataset: str, img_size: Optional[int] = None,
                     data_folder: Optional[str] = None, **kwargs):
    """RestorationModel's dataset dispatch (nppc/restoration.py:62-76)."""
    if dataset == "mnist":
        return MNISTDataModule(data_folder=data_folder, **kwargs)
    if dataset == "celeba_hq_256":
        return CelebAHQ256DataModule(img_size=img_size or 256,
                                     data_folder=data_folder, **kwargs)
    if dataset == "celeba_srflow":
        return CelebASRFlowDataModule(data_folder=data_folder, scale=8,
                                      **kwargs)
    raise ValueError(f"Unsupported dataset: {dataset!r}")
