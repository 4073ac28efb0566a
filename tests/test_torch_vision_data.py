"""Port parity of the vision data side (``paddle_tpu_torch/vision/
transforms.py``, ``vision/datasets.py``) and of the image-classification
recipe through ``hapi.Model`` on the CPU, against the JAX package.

- every transform, class and functional form, on uint8 and float images,
  gives the JAX arrays exactly (values and dtype) under one numpy seed;
- the datasets' synthetic arrays equal the JAX ones exactly (every class
  and split); the idx reader reads files the test writes (raw and gzip);
  ``DatasetFolder`` / ``ImageFolder`` index the same files;
- one epoch of the recipe's ``Model.fit`` (the synthetic MNIST,
  ``ToTensor`` + ``Normalize``, ``SmallNet``, ``Adam`` over
  ``CosineAnnealingDecay``, ``nn.CrossEntropyLoss``, ``Accuracy``,
  ``DataLoader(shuffle=True)``) from the same weights: per-batch losses,
  the history and ``evaluate``'s loss and accuracy; and the same with a
  BatchNorm2D after each conv (``fit`` trains its statistics in train
  mode, ``evaluate`` reads them in eval mode).

Tolerances: transforms and datasets exact; the recipe in float32 within
1e-4 relative for losses and the BatchNorm statistics (convolutions sum
in another order; 4 Adam steps) and accuracy exact.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.hapi import Model as TModel
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as TT


def _images():
    r = np.random.RandomState(0)
    return {"uint8_hwc": r.randint(0, 256, (12, 10, 3)).astype(np.uint8),
            "float_hwc": r.rand(12, 10, 3).astype(np.float32),
            "uint8_hw": r.randint(0, 256, (12, 10)).astype(np.uint8)}


# name: (constructor or function, arguments, inputs it takes)
RGB = ("uint8_hwc", "float_hwc")
ANY = ("uint8_hwc", "float_hwc", "uint8_hw")
TRANSFORMS = {
    "Compose": (lambda M: M.Compose([M.RandomHorizontalFlip(0.5),
                                     M.ToTensor(),
                                     M.Normalize([0.5] * 3, [0.2] * 3)]),
                RGB),
    "Normalize_hwc": (lambda M: M.Normalize([1, 2, 3], [2, 3, 4],
                                            data_format="HWC"), RGB),
    "ToTensor": (lambda M: M.ToTensor(), ANY),
    "Transpose": (lambda M: M.Transpose((2, 0, 1)), RGB),
    "Resize": (lambda M: M.Resize((7, 15)), ANY),
    "CenterCrop": (lambda M: M.CenterCrop(5), ANY),
    "RandomCrop": (lambda M: M.RandomCrop((6, 7), padding=2), ANY),
    "RandomHorizontalFlip": (lambda M: M.RandomHorizontalFlip(0.7), ANY),
    "RandomVerticalFlip": (lambda M: M.RandomVerticalFlip(0.7), ANY),
    "Pad": (lambda M: M.Pad(2, fill=7), ANY),
    "Pad_pair_reflect": (lambda M: M.Pad((1, 2), padding_mode="reflect"),
                         ANY),
    "Grayscale": (lambda M: M.Grayscale(3), RGB),
    "BrightnessTransform": (lambda M: M.BrightnessTransform(0.4), RGB),
    "ContrastTransform": (lambda M: M.ContrastTransform(0.4), RGB),
    "SaturationTransform": (lambda M: M.SaturationTransform((0.5, 1.5)),
                            RGB),
    "HueTransform": (lambda M: M.HueTransform(0.3), RGB),
    "ColorJitter": (lambda M: M.ColorJitter(0.3, 0.3, 0.3, 0.2), RGB),
    "RandomResizedCrop": (lambda M: M.RandomResizedCrop(6), ANY),
    "RandomRotation": (lambda M: M.RandomRotation(30), ANY),
    "to_tensor_hwc": (lambda M: lambda x: M.to_tensor(x, "HWC"), RGB),
    "hflip": (lambda M: M.hflip, ANY),
    "vflip": (lambda M: M.vflip, ANY),
    "resize": (lambda M: lambda x: M.resize(x, 8), ANY),
    "pad": (lambda M: lambda x: M.pad(x, (1, 2, 3, 4), fill=3), ANY),
    "crop": (lambda M: lambda x: M.crop(x, 2, 1, 5, 6), ANY),
    "center_crop": (lambda M: lambda x: M.center_crop(x, (4, 6)), ANY),
    "rotate": (lambda M: lambda x: M.rotate(x, 37.0, fill=9), ANY),
    "to_grayscale": (lambda M: M.to_grayscale, RGB),
    "adjust_brightness": (lambda M: lambda x: M.adjust_brightness(x, 1.3),
                          RGB),
    "adjust_contrast": (lambda M: lambda x: M.adjust_contrast(x, 0.6), RGB),
    "adjust_hue": (lambda M: lambda x: M.adjust_hue(x, -0.2), RGB),
    "normalize": (lambda M: lambda x: M.normalize(
        np.asarray(x, np.float32).transpose(2, 0, 1), [0.4] * 3,
        [0.3] * 3), RGB),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_exact_under_one_seed(name):
    make, kinds = TRANSFORMS[name]
    jt, tt = make(JT), make(TT)
    for kind in kinds:
        x = _images()[kind]
        for seed in (0, 1, 2):
            np.random.seed(seed)
            ref = jt(x.copy())
            np.random.seed(seed)
            got = tt(x.copy())
            assert np.asarray(got).dtype == np.asarray(ref).dtype, kind
            np.testing.assert_array_equal(got, ref, err_msg=f"{kind} {seed}")


def test_base_transform_routes_keys():
    class Flip(TT.BaseTransform):
        def _apply_image(self, image):
            return TT.hflip(image)

        def _apply_mask(self, mask):
            return mask[::-1]

    img, mask = _images()["uint8_hw"], np.arange(4)
    out = Flip(keys=("image", "mask", "label"))((img, mask, 7))
    np.testing.assert_array_equal(out[0], JT.hflip(img))
    np.testing.assert_array_equal(out[1], mask[::-1])
    assert out[2] == 7
    np.testing.assert_array_equal(Flip()(img), JT.hflip(img))


DATASETS = {
    "MNIST_train": lambda D: D.MNIST(mode="train", synthetic_size=64),
    "MNIST_test_default": lambda D: D.MNIST(mode="test"),
    "FashionMNIST": lambda D: D.FashionMNIST(mode="test", synthetic_size=32),
    "Cifar10": lambda D: D.Cifar10(mode="train", synthetic_size=32),
    "Cifar100": lambda D: D.Cifar100(mode="test", synthetic_size=32),
    "Flowers_train": lambda D: D.Flowers(mode="train", synthetic_size=16),
    "Flowers_valid": lambda D: D.Flowers(mode="valid", synthetic_size=16),
    "VOC2012": lambda D: D.VOC2012(mode="valid", synthetic_size=8,
                                   image_hw=(16, 24)),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_synthetic_dataset_exact(name):
    jd, td = DATASETS[name](jds), DATASETS[name](tds)
    assert len(td) == len(jd)
    for attr in ("images", "labels", "masks"):
        if hasattr(jd, attr):
            ref, got = getattr(jd, attr), getattr(td, attr)
            assert got.dtype == ref.dtype, attr
            np.testing.assert_array_equal(got, ref, err_msg=attr)
    for i in (0, len(td) - 1):
        for got, ref in zip(td[i], jd[i]):
            np.testing.assert_array_equal(got, ref)


def test_download_fetches_nothing():
    ds = tds.MNIST(mode="test", download=True, synthetic_size=4)
    np.testing.assert_array_equal(
        ds.images, jds.MNIST(mode="test", synthetic_size=4).images)


@pytest.mark.parametrize("compressed", [False, True])
def test_idx_reader(tmp_path, compressed):
    r = np.random.RandomState(9)
    imgs = r.randint(0, 256, (5, 4, 3)).astype(np.uint8)
    labels = r.randint(0, 10, 5).astype(np.uint8)
    suffix = ".gz" if compressed else ""
    opener = gzip.open if compressed else open
    ipath, lpath = tmp_path / f"img{suffix}", tmp_path / f"lab{suffix}"
    with opener(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 4, 3) + imgs.tobytes())
    with opener(lpath, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    td = tds.MNIST(image_path=str(ipath), label_path=str(lpath),
                   transform=TT.ToTensor())
    jd = jds.MNIST(image_path=str(ipath), label_path=str(lpath),
                   transform=JT.ToTensor())
    np.testing.assert_array_equal(td.images, imgs)
    np.testing.assert_array_equal(td.labels, labels.astype(np.int64))
    assert td.labels.dtype == jd.labels.dtype == np.int64
    for i in range(5):
        np.testing.assert_array_equal(td[i][0], jd[i][0])


@pytest.mark.parametrize("cls", ["DatasetFolder", "ImageFolder"])
def test_folders_index_the_same_files(tmp_path, cls):
    for c in ("b", "a"):
        (tmp_path / c).mkdir()
        for i in range(2):
            np.save(tmp_path / c / f"{i}.npy", np.full((2, 2), i, np.uint8))
        (tmp_path / c / "README").write_text("not an image")

    def build(D):
        return getattr(D, cls)(str(tmp_path), loader=np.load,
                               extensions=".npy")
    jd, td = build(jds), build(tds)
    assert len(td) == len(jd) == 4
    assert td.samples == jd.samples
    for i in range(4):
        for got, ref in zip(td[i], jd[i]):
            np.testing.assert_array_equal(got, ref)


# -- the image-classification recipe through Model.fit -------------------------
def _small_net(nn, bn=False, **dev):
    """The recipe's ``SmallNet``; ``bn`` puts a ``BatchNorm2D`` after each
    conv (a network whose train and eval modes differ), the conv then
    without a bias, as in the ResNets (its gradient would be rounding
    noise, which Adam turns into steps of about lr)."""
    def norm(c):
        return nn.BatchNorm2D(c, **dev) if bn else nn.Identity()
    lin = dict(dev)
    if bn:
        dev = {**dev, "bias_attr": False}

    class SmallNet(nn.Layer if hasattr(nn, "Layer") else torch.nn.Module):
        def __init__(self, num_classes=10):
            super().__init__()
            self.features = nn.Sequential(
                nn.Conv2D(1, 8, 3, padding=1, **dev), norm(8), nn.ReLU(),
                nn.MaxPool2D(2),
                nn.Conv2D(8, 16, 3, padding=1, **dev), norm(16), nn.ReLU(),
                nn.MaxPool2D(2))
            self.head = nn.Sequential(nn.Flatten(),
                                      nn.Linear(16 * 7 * 7, num_classes,
                                                **lin))

        def forward(self, x):
            return self.head(self.features(x))
    return SmallNet()


@pytest.mark.parametrize("bn", [False, True])
def test_recipe_fit_epoch_matches_jax(bn):
    """``examples/image_classification.py``'s recipe, one epoch at a
    quarter of its data, from the same weights; with ``bn`` the network's
    BatchNorm statistics are trained by ``fit`` and read by
    ``evaluate``."""
    pt.seed(0)
    jnet = _small_net(jnn, bn)
    tnet = _small_net(tnn, bn, device="cpu")
    load_jax_state(tnet, {k: np.array(v) for k, v in
                          jnet.state_dict().items()})
    runs = []
    for T, D, io, metric, opt, Model, net in (
            (JT, jds, jio, jmetric, jopt, JModel, jnet),
            (TT, tds, tio, tmetric, topt, TModel, tnet)):
        plain = T.Compose([T.ToTensor(), T.Normalize([0.5], [0.5])])
        train = D.MNIST(mode="train", transform=plain, synthetic_size=512)
        test = D.MNIST(mode="test", transform=plain, synthetic_size=256)
        sched = opt.lr.CosineAnnealingDecay(3e-3, T_max=160)
        kw = {} if opt is jopt else {"parameters": net.named_parameters()}
        model = Model(net)
        loss = (jnn.CrossEntropyLoss() if opt is jopt
                else tnn.CrossEntropyLoss())
        model.prepare(opt.Adam(learning_rate=sched, **kw), loss,
                      metric.Accuracy())
        loader_kw = {} if opt is jopt else {"places": "cpu"}
        np.random.seed(0)
        hist = model.fit(io.DataLoader(train, batch_size=128, shuffle=True,
                                       **loader_kw), epochs=1, verbose=0)
        res = model.evaluate(io.DataLoader(test, batch_size=256,
                                           **loader_kw), verbose=0)
        runs.append((hist["loss"], res, sched.last_epoch,
                     {k: np.asarray(v) for k, v in net.state_dict().items()
                      if k.endswith(("_mean", "_variance"))}))
    (jl, jres, jep, jstats), (tl, tres, tep, tstats) = runs
    assert sorted(tstats) == sorted(jstats) and len(tstats) == 4 * bn
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k], v, rtol=1e-4, atol=1e-6)
    assert len(tl) == len(jl) == 4 and tep == jep == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    assert tres["acc"] == jres["acc"]


def test_image_backend_as_jax():
    from paddle_tpu import vision as jvision
    from paddle_tpu_torch import vision as tvision
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    assert tvision.get_image_backend() == jvision.get_image_backend()
    try:
        tvision.set_image_backend("cv2")
        assert tvision.get_image_backend() == "cv2"
        with pytest.raises(InvalidArgumentError):
            tvision.set_image_backend("opencv")
    finally:
        tvision.set_image_backend("pil")
