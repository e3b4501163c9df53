"""Vision datasets (port of paddle_tpu/vision/datasets/__init__.py, the
same code).

Nothing is downloaded: MNIST and FashionMNIST read IDX files when given
their paths, and every dataset otherwise falls back to a deterministic
synthetic backend of class-conditional images, so a sample equals the
reference's bit for bit. As in the reference, the synthetic MNIST backend
does not apply ``transform``, and its train and test splits draw their
class means from different seeds.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "ImageFolder",
           "DatasetFolder", "Flowers", "VOC2012"]


class _SyntheticImageDataset(Dataset):
    def __init__(self, num_samples, shape, num_classes, transform=None,
                 seed=0, dtype="float32"):
        self.num_samples = num_samples
        self.shape = shape
        self.num_classes = num_classes
        self.transform = transform
        rng = np.random.RandomState(seed)
        # class-conditional means so models can actually learn
        self._means = rng.uniform(-1, 1, size=(num_classes,) + shape).astype("float32")
        self._labels = rng.randint(0, num_classes, size=num_samples)
        self._seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx)
        y = self._labels[idx]
        img = self._means[y] + 0.3 * rng.randn(*self.shape).astype("float32")
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(y, dtype=np.int64)

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """MNIST; reads IDX files if present at `image_path`/`label_path`, else
    synthetic fallback (28x28x1, 10 classes)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and label_path and os.path.exists(image_path):
            self.images, self.labels = self._load_idx(image_path, label_path)
        else:
            n = 60000 if mode == "train" else 10000
            n = min(n, 4096)  # hermetic default size
            synth = _SyntheticImageDataset(n, (1, 28, 28), 10,
                                           seed=0 if mode == "train" else 1)
            self._synth = synth
            self.images = None
            self.labels = None

    @staticmethod
    def _load_idx(image_path, label_path):
        with gzip.open(image_path, "rb") if image_path.endswith(".gz") \
                else open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") if label_path.endswith(".gz") \
                else open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8)
        return images, labels

    def __getitem__(self, idx):
        if self.images is None:
            return self._synth[idx]
        img = self.images[idx].astype("float32")[None] / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self._synth) if self.images is None else len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        n = 50000 if mode == "train" else 10000
        n = min(n, 4096)
        self._synth = _SyntheticImageDataset(n, (3, 32, 32), 10,
                                             transform=transform,
                                             seed=2 if mode == "train" else 3)

    def __getitem__(self, idx):
        return self._synth[idx]

    def __len__(self):
        return len(self._synth)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        n = min(50000 if mode == "train" else 10000, 4096)
        self._synth = _SyntheticImageDataset(n, (3, 32, 32), 100,
                                             transform=transform,
                                             seed=4 if mode == "train" else 5)


class Flowers(Dataset):
    """Flowers-102 (vision/datasets/flowers.py parity); synthetic fallback
    (3x96x96, 102 classes) when the archive files are absent."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        n = min(6149 if mode == "train" else 1020, 2048)
        self._synth = _SyntheticImageDataset(
            n, (3, 96, 96), 102, transform=transform,
            seed=6 if mode == "train" else 7)

    def __getitem__(self, idx):
        return self._synth[idx]

    def __len__(self):
        return len(self._synth)


class VOC2012(Dataset):
    """VOC2012 segmentation (vision/datasets/voc2012.py parity); synthetic
    fallback yields (image, mask) pairs with 21 classes."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        self.num_samples = min(2913, 512)
        self._seed = 8 if mode == "train" else 9

    def __getitem__(self, idx):
        # seed*100003 decorrelates the per-split streams (seed+idx would make
        # train sample i+1 identical to test sample i)
        rng = np.random.RandomState(self._seed * 100003 + idx)
        img = rng.rand(3, 64, 64).astype("float32")
        mask = rng.randint(0, 21, (64, 64)).astype("int64")
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return self.num_samples


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        exts = extensions or (".png", ".jpg", ".jpeg", ".npy")
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                if fn.lower().endswith(tuple(exts)):
                    self.samples.append((os.path.join(root, c, fn),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"),
                              dtype=np.float32).transpose(2, 0, 1) / 255.0
        except ImportError:
            raise RuntimeError("PIL unavailable; use .npy images")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(target, dtype=np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    pass
