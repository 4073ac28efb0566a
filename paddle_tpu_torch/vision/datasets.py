"""Vision datasets: the port of ``paddle_tpu/vision/datasets.py``.  They
load from local files when present (the idx / gz formats of MNIST) and
otherwise build the JAX module's deterministic synthetic arrays, exactly.
Nothing is downloaded: ``download=True`` fetches nothing, as in the JAX
classes.  PIL is imported only where an image file is opened."""
from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Optional

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "ImageFolder", "DatasetFolder"]


def _load_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def _load_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int64)


def _synthetic_classes(n: int, seed: int, shape, proto_seed: int,
                       noise: float = 0.3, num_classes: int = 10):
    """Deterministic learnable class data: each class is a distinct
    pattern plus per-sample noise.  The class prototypes come from a FIXED
    seed shared by every split — train and test must agree on what the
    classes look like; only the sampling noise differs by ``seed``."""
    protos = np.random.RandomState(proto_seed).rand(
        num_classes, *shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    imgs = np.clip(protos[labels]
                   + noise * rng.randn(n, *shape).astype(np.float32), 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def _synthetic_digits(n: int, seed: int, image_hw=(28, 28)):
    return _synthetic_classes(n, seed, image_hw, proto_seed=1234)


class MNIST(Dataset):
    """paddle.vision.datasets.MNIST analog (reference
    python/paddle/vision/datasets/mnist.py)."""

    NUM_CLASSES = 10

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 backend: str = "cv2", synthetic_size: Optional[int] = None):
        self.transform = transform
        self.mode = mode
        if image_path and os.path.exists(image_path):
            self.images = _load_idx_images(image_path)
            self.labels = _load_idx_labels(label_path)
        else:
            n = synthetic_size or (4096 if mode == "train" else 512)
            self.images, self.labels = _synthetic_digits(
                n, seed=7 if mode == "train" else 11)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 synthetic_size: Optional[int] = None):
        self.transform = transform
        n = synthetic_size or (2048 if mode == "train" else 256)
        self.images, self.labels = _synthetic_classes(
            n, seed=13 if mode == "train" else 17, shape=(32, 32, 3),
            proto_seed=4321, noise=0.25)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 synthetic_size: Optional[int] = None):
        self.transform = transform
        n = synthetic_size or (2048 if mode == "train" else 256)
        self.images, self.labels = _synthetic_classes(
            n, seed=19 if mode == "train" else 23, shape=(32, 32, 3),
            proto_seed=8765, noise=0.25, num_classes=100)


class Flowers(Dataset):
    """paddle.vision.datasets.Flowers analog (reference
    python/paddle/vision/datasets/flowers.py:43): 102-category flower
    classification with train/valid/test splits.  Zero-egress default:
    deterministic learnable synthetic classes (shared prototypes across
    splits, split-specific noise)."""

    NUM_CLASSES = 102

    def __init__(self, data_file: Optional[str] = None,
                 label_file: Optional[str] = None,
                 setid_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2",
                 synthetic_size: Optional[int] = None):
        assert mode in ("train", "valid", "test"), mode
        self.transform = transform
        self.mode = mode
        n = synthetic_size or {"train": 1024, "valid": 128,
                               "test": 256}[mode]
        seed = {"train": 29, "valid": 31, "test": 37}[mode]
        self.images, self.labels = _synthetic_classes(
            n, seed=seed, shape=(64, 64, 3), proto_seed=10246,
            noise=0.25, num_classes=self.NUM_CLASSES)
        self.labels = self.labels + 1   # reference labels are 1-based

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.images)


class VOC2012(Dataset):
    """paddle.vision.datasets.VOC2012 analog (reference
    python/paddle/vision/datasets/voc2012.py:40): segmentation pairs
    (image, per-pixel label mask over 21 classes).  Zero-egress default:
    each sample places a class-colored rectangle on a noise background
    with the exactly-matching mask — learnable by a small conv net."""

    NUM_CLASSES = 21

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2",
                 synthetic_size: Optional[int] = None, image_hw=(64, 64)):
        assert mode in ("train", "valid", "test"), mode
        self.transform = transform
        self.mode = mode
        n = synthetic_size or {"train": 512, "valid": 64, "test": 128}[mode]
        rng = np.random.RandomState({"train": 41, "valid": 43,
                                     "test": 47}[mode])
        colors = np.random.RandomState(20127).rand(
            self.NUM_CLASSES, 3).astype(np.float32)
        H, W = image_hw
        imgs = rng.rand(n, H, W, 3).astype(np.float32) * 0.3
        masks = np.zeros((n, H, W), np.int64)
        for i in range(n):
            cls = rng.randint(1, self.NUM_CLASSES)
            h0, w0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
            h1 = h0 + rng.randint(H // 4, H // 2)
            w1 = w0 + rng.randint(W // 4, W // 2)
            imgs[i, h0:h1, w0:w1] = (
                colors[cls] + 0.1 * rng.randn(h1 - h0, w1 - w0, 3)
            ).clip(0, 1)
            masks[i, h0:h1, w0:w1] = cls
        self.images = (imgs * 255).astype(np.uint8)
        self.masks = masks

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


# reference folder.py IMG_EXTENSIONS — stray non-image files (README,
# .DS_Store, csv sidecars) must not enter the sample list
IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp")


def _default_loader(path):
    return np.asarray(__import__("PIL.Image", fromlist=["open"]).open(path))


def _has_valid_ext(fname: str, extensions) -> bool:
    if isinstance(extensions, str):   # a bare ".npy" must not explode into
        extensions = (extensions,)    # per-character suffixes via tuple()
    return fname.lower().endswith(tuple(extensions))


class DatasetFolder(Dataset):
    """Reference: vision/datasets/folder.py — class-per-subdir image tree.
    Only files matching ``extensions`` (IMG_EXTENSIONS by default) are
    indexed; an empty result raises like the reference."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 extensions=IMG_EXTENSIONS):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if _has_valid_ext(fname, extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"Found 0 files in subfolders of {root}; supported "
                f"extensions: {','.join(extensions)}")

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Reference: vision/datasets/folder.py ImageFolder — a flat recursive
    scan of image files under ``root``; unlike DatasetFolder items carry
    NO label (the reference yields ``[sample]``)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 extensions=IMG_EXTENSIONS):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        self.samples = []
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            for fname in sorted(filenames):
                if _has_valid_ext(fname, extensions):
                    self.samples.append(os.path.join(dirpath, fname))
        if not self.samples:
            raise RuntimeError(
                f"Found 0 files in {root}; supported extensions: "
                f"{','.join(extensions)}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
