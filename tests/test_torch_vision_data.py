"""The port's vision datasets and transforms against the reference's on
the host.

Datasets: every synthetic backend, the IDX reader and DatasetFolder give
the reference's samples bit for bit (values, shapes, dtypes).

Transforms: each one runs on the same numpy image under the same
``np.random.seed`` in both packages, and must give the same result
exactly, apart from the linear resize (``Resize`` and the resize inside
``RandomResizedCrop``). The reference resizes with ``jax.image.resize``
compiled by XLA and the port with its own numpy weights in float64, so
the two differ by float32 rounding: RESIZE_TOL, |err| <= 2e-6 + 1e-6 *
|ref|, holds enlarging (96 -> 224, where the measured gap is below 5e-7
on values up to 4.5) and shrinking (224 -> 37 x 91, with jax's
antialiasing, below 2e-7) alike. Enlarging is also bilinear interpolation
with half-pixel centres: torch's ``interpolate(mode="bilinear",
align_corners=False)`` agrees to the same bound.
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu.vision.datasets as rds  # noqa: E402
import paddle_tpu.vision.transforms as rT  # noqa: E402

import paddle_tpu_torch.vision.datasets as pds  # noqa: E402
import paddle_tpu_torch.vision.transforms as pT  # noqa: E402

torch.set_num_threads(1)

RESIZE_TOL = dict(atol=2e-6, rtol=1e-6)


def _same_sample(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


DATASETS = {
    "mnist_train": lambda m: m.MNIST(mode="train"),
    "mnist_test": lambda m: m.MNIST(mode="test"),
    "fashion_mnist": lambda m: m.FashionMNIST(mode="train"),
    "cifar10": lambda m: m.Cifar10(mode="train"),
    "cifar100_test": lambda m: m.Cifar100(mode="test"),
    "flowers_train": lambda m: m.Flowers(mode="train"),
    "flowers_test": lambda m: m.Flowers(mode="test"),
    "voc2012": lambda m: m.VOC2012(mode="train"),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_synthetic_datasets_bit_for_bit(name):
    port, ref = DATASETS[name](pds), DATASETS[name](rds)
    assert len(port) == len(ref)
    for i in (0, 1, 7, len(ref) - 1):
        _same_sample(port[i], ref[i])


def test_transform_reaches_the_synthetic_backends_as_in_the_reference():
    """Cifar10 and Flowers apply ``transform``; the synthetic MNIST does
    not (ROADMAP C-ref-8), in both packages."""
    for m, T in ((pds, pT), (rds, rT)):
        norm = T.Normalize(mean=0.5, std=0.5)
        plain, with_t = m.MNIST(mode="train"), m.MNIST(mode="train",
                                                       transform=norm)
        np.testing.assert_array_equal(plain[3][0], with_t[3][0])
        c = m.Cifar10(mode="train", transform=norm)
        np.testing.assert_array_equal(
            c[3][0], norm(m.Cifar10(mode="train")[3][0]))


def _write_idx(tmp_path, gz):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 4, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (5,)).astype(np.uint8)
    opener = gzip.open if gz else open
    ip = str(tmp_path / ("img.idx" + (".gz" if gz else "")))
    lp = str(tmp_path / ("lab.idx" + (".gz" if gz else "")))
    with opener(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 4, 3) + imgs.tobytes())
    with opener(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_matches_reference(tmp_path, gz):
    ip, lp = _write_idx(tmp_path, gz)
    norm = pT.Normalize(mean=0.1, std=2.0)
    port = pds.MNIST(image_path=ip, label_path=lp, transform=norm)
    ref = rds.MNIST(image_path=ip, label_path=lp,
                    transform=rT.Normalize(mean=0.1, std=2.0))
    assert len(port) == len(ref) == 5
    for i in range(5):
        _same_sample(port[i], ref[i])


def test_dataset_folder_matches_reference(tmp_path):
    rng = np.random.RandomState(1)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for j in range(2):
            np.save(tmp_path / c / f"{j}.npy",
                    rng.rand(3, 5, 5).astype(np.float32))
    port = pds.ImageFolder(str(tmp_path))
    ref = rds.ImageFolder(str(tmp_path))
    assert port.class_to_idx == ref.class_to_idx == {"cat": 0, "dog": 1}
    for i in range(4):
        _same_sample(port[i], ref[i])


# -- transforms ----------------------------------------------------------------

def _img(layout, seed=0, size=(3, 20, 16), scale=1.0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(*size) * scale).astype(np.float32)
    return a if layout == "CHW" else np.ascontiguousarray(
        a.transpose(1, 2, 0))


TRANSFORMS = {
    "to_tensor": lambda T, fmt: T.ToTensor(),
    "normalize": lambda T, fmt: T.Normalize(mean=[0.4, 0.5, 0.6],
                                            std=[0.2, 0.3, 0.4],
                                            data_format=fmt),
    "center_crop": lambda T, fmt: T.CenterCrop(10),
    "random_crop": lambda T, fmt: T.RandomCrop((12, 9)),
    "random_crop_padded": lambda T, fmt: T.RandomCrop(18, padding=2),
    "hflip": lambda T, fmt: T.RandomHorizontalFlip(prob=0.5),
    "vflip": lambda T, fmt: T.RandomVerticalFlip(prob=0.5),
    "transpose": lambda T, fmt: T.Transpose((1, 2, 0)),
    "pad_constant": lambda T, fmt: T.Pad(2, fill=0.5),
    "pad_edge": lambda T, fmt: T.Pad((1, 2, 3, 4), padding_mode="edge"),
    "pad_reflect": lambda T, fmt: T.Pad((1, 2), padding_mode="reflect"),
    "rotation": lambda T, fmt: T.RandomRotation(30),
    "rotation_expand": lambda T, fmt: T.RandomRotation((80, 100),
                                                       expand=True),
    "grayscale": lambda T, fmt: T.Grayscale(3),
    "brightness": lambda T, fmt: T.BrightnessTransform(0.4),
    "contrast": lambda T, fmt: T.ContrastTransform(0.4),
    "saturation": lambda T, fmt: T.SaturationTransform(0.4),
    "hue": lambda T, fmt: T.HueTransform(0.2),
    "color_jitter": lambda T, fmt: T.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "compose": lambda T, fmt: T.Compose([T.RandomCrop(14),
                                         T.Normalize(0.5, 0.5,
                                                     data_format=fmt),
                                         T.RandomHorizontalFlip()]),
}


@pytest.mark.parametrize("layout", ["CHW", "HWC"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_reference(name, layout):
    port, ref = TRANSFORMS[name](pT, layout), TRANSFORMS[name](rT, layout)
    for seed in range(3):
        img = _img(layout, seed, scale=255.0 if seed == 2 else 1.0)
        np.random.seed(seed)
        p = port(img.copy())
        np.random.seed(seed)
        r = ref(img.copy())
        assert p.shape == r.shape and p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)


FUNCTIONS = {
    "to_tensor": lambda T, a: T.to_tensor(a),
    "normalize": lambda T, a: T.normalize(a, 0.5, 0.25),
    "hflip": lambda T, a: T.hflip(a),
    "vflip": lambda T, a: T.vflip(a),
    "crop": lambda T, a: T.crop(a, 2, 3, 8, 7),
    "center_crop": lambda T, a: T.center_crop(a, (9, 11)),
    "pad": lambda T, a: T.pad(a, 3, padding_mode="symmetric"),
    "rotate": lambda T, a: T.rotate(a, 45.0, center=(4, 6)),
    "to_grayscale": lambda T, a: T.to_grayscale(a),
    "adjust_brightness": lambda T, a: T.adjust_brightness(a, 1.3),
    "adjust_contrast": lambda T, a: T.adjust_contrast(a, 0.7),
    "adjust_saturation": lambda T, a: T.adjust_saturation(a, 1.5),
    "adjust_hue": lambda T, a: T.adjust_hue(a, -0.3),
}


@pytest.mark.parametrize("layout", ["CHW", "HWC"])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functional_transforms_match_reference(name, layout):
    img = _img(layout, 4)
    p = FUNCTIONS[name](pT, img.copy())
    r = FUNCTIONS[name](rT, img.copy())
    assert p.shape == r.shape and p.dtype == r.dtype
    np.testing.assert_array_equal(p, r)


RESIZES = {
    "enlarge_square": ((3, 96, 96), (224, 224)),
    "enlarge_oblong": ((3, 33, 70), (224, 224)),
    "shrink": ((3, 224, 224), (37, 91)),
    "shrink_hwc": ((40, 30, 3), (9, 31)),
    "mixed": ((3, 30, 60), (45, 20)),
    "one_axis": ((1, 28, 28), (28, 56)),
}


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_matches_reference(name):
    shape, size = RESIZES[name]
    img = np.random.RandomState(2).randn(*shape).astype(np.float32) * 2
    p = pT.Resize(size)(img)
    r = rT.Resize(size)(img)
    assert p.shape == r.shape and p.dtype == r.dtype == np.float32
    np.testing.assert_allclose(p, r, **RESIZE_TOL)
    np.testing.assert_allclose(pT.resize(img, size), p, rtol=0, atol=0)
    chw = shape[0] in (1, 3, 4)
    if chw and size[0] >= shape[1] and size[1] >= shape[2]:
        bilinear = torch.nn.functional.interpolate(
            torch.from_numpy(img)[None], size=size, mode="bilinear",
            align_corners=False)[0].numpy()
        np.testing.assert_allclose(p, bilinear, **RESIZE_TOL)


@pytest.mark.parametrize("layout", ["CHW", "HWC"])
def test_random_resized_crop_matches_reference(layout):
    """PaddleClas's training crop: the same draws (scale, ratio, offsets)
    in the same order, then the linear resize to 224."""
    port = pT.RandomResizedCrop(224)
    ref = rT.RandomResizedCrop(224)
    for seed in range(4):
        img = _img(layout, seed, size=(3, 96, 96))
        np.random.seed(seed)
        p = port(img)
        np.random.seed(seed)
        r = ref(img)
        np.testing.assert_allclose(p, r, **RESIZE_TOL)
    np.random.seed(0)
    pipeline = pT.Compose([pT.RandomResizedCrop(224),
                           pT.RandomHorizontalFlip(),
                           pT.Normalize([0.485, 0.456, 0.406],
                                        [0.229, 0.224, 0.225])])
    out = pipeline(_img("CHW", 9, size=(3, 96, 96)))
    assert out.shape == (3, 224, 224) and out.dtype == np.float32
