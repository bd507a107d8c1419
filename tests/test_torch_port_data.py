"""flowerdiff_torch's Flowers102 loader and v3 color labels against the JAX
package's, on a dataset in torchvision's layout that the test writes itself
(as tests/test_flowers102.py does) and on synthetic swatches and flowers.

Both loaders decode through their native libraries when those are built;
the bit-equality tests disable both (`flowerdiff.native._load`,
`flowerdiff_torch.native._load`), so both decode with PIL and the images
must be bit-equal (the native decoders are held to each other in
tests/test_torch_port_native.py). The color labels are numpy and sklearn on both
sides: names and indices must be equal."""
import os

import numpy as np
import pytest
import scipy.io
from PIL import Image

import flowerdiff.native
import flowerdiff_torch.native
from flowerdiff.data import color_labels as jcolor
from flowerdiff.data import flowers102 as jflowers
from flowerdiff_torch.data import color_labels as color
from flowerdiff_torch.data import flowers102 as flowers
from flowerdiff_torch.data import synthetic_flowers
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)

IDS = {"train": (1, 4, 7, 10), "val": (2, 5, 8), "test": (3, 6, 9, 11, 12)}


@pytest.fixture()
def flowers_root(tmp_path):
    """12 JPEGs of two sizes, 1-based labels and the three id splits, in
    torchvision's layout; image id i carries a marker block of value
    (20 i) mod 255 in its top-left corner."""
    base = tmp_path / "flowers-102"
    jpg = base / "jpg"
    jpg.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(1, 13):
        arr = rng.integers(0, 255, (40, 50, 3) if i % 2 else (57, 31, 3), dtype=np.uint8)
        arr[:8, :8] = (i * 20) % 255
        Image.fromarray(arr).save(jpg / f"image_{i:05d}.jpg", quality=95)
    labels = (np.arange(12) % 5) + 1
    scipy.io.savemat(base / "imagelabels.mat", {"labels": labels[None, :]})
    scipy.io.savemat(base / "setid.mat", {"trnid": np.array([IDS["train"]]),
                                          "valid": np.array([IDS["val"]]),
                                          "tstid": np.array([IDS["test"]])})
    return str(tmp_path)


@pytest.fixture()
def pil_reference(monkeypatch):
    monkeypatch.setattr(flowerdiff.native, "_load", lambda: None)
    monkeypatch.setattr(flowerdiff_torch.native, "_load", lambda: None)


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("size", [32, 64])
def test_loader_is_bit_equal_to_the_reference(flowers_root, pil_reference, split, size):
    got_imgs, got_labels = flowers.load_flowers102(flowers_root, split, img_size=size,
                                                   cache=False)
    want_imgs, want_labels = jflowers.load_flowers102(flowers_root, split, img_size=size,
                                                      cache=False)
    assert got_imgs.dtype == want_imgs.dtype == np.uint8
    assert got_labels.dtype == want_labels.dtype == np.int32
    assert got_imgs.shape == (len(IDS[split]), size, size, 3)
    np.testing.assert_array_equal(got_imgs, want_imgs)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_labels, [(i - 1) % 5 for i in IDS[split]])


def test_loader_keeps_the_split_order(flowers_root):
    imgs, _ = flowers.load_flowers102(flowers_root, "test", img_size=32, cache=False)
    for row, image_id in enumerate(IDS["test"]):
        assert abs(float(imgs[row, :3, :3].mean()) - (image_id * 20) % 255) < 30, image_id


def test_cache_round_trips_and_is_the_reference_format(flowers_root, pil_reference,
                                                       monkeypatch):
    first = flowers.load_flowers102(flowers_root, "train", img_size=32, cache=True)
    cache = os.path.join(flowers_root, "flowers-102", "cache_train_32.npz")
    assert os.path.exists(cache)

    def no_decode(*_args, **_kw):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(flowers, "decode_jpegs", no_decode)
    again = flowers.load_flowers102(flowers_root, "train", img_size=32, cache=True)
    reference = jflowers.load_flowers102(flowers_root, "train", img_size=32, cache=True)
    for a, b, c in zip(first, again, reference):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_missing_dataset_raises_and_points_at_the_synthetic_set(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic"):
        flowers.load_flowers102(str(tmp_path / "nowhere"), "train")


def test_an_undecodable_file_raises(flowers_root):
    with open(os.path.join(flowers_root, "flowers-102", "jpg", "image_00004.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    with pytest.raises(IOError, match="failed to decode 1 images"):
        flowers.load_flowers102(flowers_root, "train", img_size=32, cache=False)


def test_class_names_and_splits_are_the_reference_s():
    assert flowers.class_names() == jflowers.class_names() == [str(i) for i in range(102)]
    assert flowers.FLOWERS102_SPLITS == jflowers.FLOWERS102_SPLITS


# ------------------------------------------------------------------ color labels


def _swatches():
    """16x16 images: solid colors with seeded noise (one per rule of the
    cascade and some between), a two-color image, a dark image whose
    pixels the brightness filter drops, and a float image in [0, 1]."""
    rng = np.random.default_rng(3)
    rgbs = [(230, 20, 30), (250, 170, 190), (30, 40, 220), (240, 230, 30), (250, 150, 20),
            (120, 30, 140), (120, 70, 40), (245, 245, 245), (30, 160, 40), (90, 90, 90),
            (20, 200, 200), (200, 20, 160)]
    out = []
    for rgb in rgbs:
        img = np.asarray(rgb, np.float32) + rng.normal(0, 12, (16, 16, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    two = np.zeros((16, 16, 3), np.uint8)
    two[:, :8] = (240, 230, 30)
    two[:, 8:] = (120, 30, 140)
    out.append(two)
    out.append(np.full((16, 16, 3), 10, np.uint8))  # too dark: "unknown"
    out.append(out[0].astype(np.float32) / 255.0)
    return out


@pytest.mark.parametrize("i", range(len(_swatches())))
def test_color_category_equals_the_reference_on_swatches(i):
    img = _swatches()[i]
    assert color.extract_color_category(img) == jcolor.extract_color_category(img)


def test_color_rules_equal_the_reference():
    assert color.COLOR_CATEGORIES == jcolor.COLOR_CATEGORIES
    assert color.COLOR_MAPPING == jcolor.COLOR_MAPPING
    assert color.COLOR_NAMES == jcolor.COLOR_NAMES
    rng = np.random.default_rng(5)
    for r, g, b in rng.random((400, 3)):
        hsv = color.rgb_to_hsv(r, g, b)
        assert hsv == jcolor.rgb_to_hsv(r, g, b)
        assert color.hsv_to_color_name(*hsv) == jcolor.hsv_to_color_name(*hsv)
        assert (color.fallback_nearest_color(255 * r, 255 * g, 255 * b)
                == jcolor.fallback_nearest_color(255 * r, 255 * g, 255 * b))
    for v in (0.0, 0.5, 1.0):  # gray: zero spread
        assert color.rgb_to_hsv(v, v, v) == jcolor.rgb_to_hsv(v, v, v)


def test_color_labels_equal_the_reference_on_synthetic_flowers():
    images, _ = synthetic_flowers(64, 102, 64, seed=0)
    got_labels, got_names = color.extract_color_labels_cached(images)
    want_labels, want_names = jcolor.extract_color_labels_cached(images)
    assert got_labels.dtype == np.int32
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got_names == want_names


def test_color_cache_round_trips(tmp_path, monkeypatch):
    images = np.stack(_swatches()[:6])
    path = str(tmp_path / "sub" / "color_labels.npz")
    labels, names = color.extract_color_labels_cached(images, cache_path=path)
    assert os.path.exists(path)

    def fail(_img):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(color, "extract_color_category", fail)
    again, again_names = color.extract_color_labels_cached(images, cache_path=path)
    np.testing.assert_array_equal(labels, again)
    assert names == again_names
    want, want_names = jcolor.extract_color_labels_cached(images, cache_path=path)
    np.testing.assert_array_equal(labels, want)  # the reference reads the port's cache
    assert want_names == names
    with pytest.raises(AssertionError, match="cache was not read"):
        color.extract_color_labels_cached(images[:5], cache_path=path)  # another length


def test_unknown_maps_to_white():
    dark = np.full((2, 16, 16, 3), 10, np.uint8)
    labels, names = color.extract_color_labels_cached(dark)
    assert names == ["unknown", "unknown"]
    np.testing.assert_array_equal(labels, [color.COLOR_MAPPING["white"]] * 2)
