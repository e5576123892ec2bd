"""Port parity of the JPEG data path: ``ImageFolder`` and the decoders against the JAX package's PIL path.

Test JPEGs are written here by PIL. On the CPU the port decodes with its own
libjpeg shim (``csrc/jpeg_cpu.cpp``) to the component planes and converts
them with :func:`~semanticlens_tpu_torch.data.native_decoder.planes_to_rgb`
(the code the card runs on nvJPEG's planes); the full-resolution decode must
equal PIL's exactly. After the resize the tolerance is one level: PIL
resamples in fixed point, the port in float32 (both round to uint8 after each
of the two passes). The committed fixtures under ``tests/data/torch_jpeg``
(the card's decode check in ``chip_smoke.py``) are held to the JAX package's
arrays exactly.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from semanticlens_tpu.data.image_folder import ImageFolder as JFolder
from semanticlens_tpu_torch.data import ArrayDataset, ImageFolder, image_decode, iter_batches, native_decoder
from semanticlens_tpu_torch.data.dataset import device_prefetch_batches

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_jpeg"
SIZE = 64  # image_size of the small cases


def _scene(w, h, seed=0):
    """Smooth gradients, sharp coloured discs and mild noise: chroma edges JPEG must keep."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / w, 255 * y / h, 128 + 100 * np.sin((x + y) / 9.0)], -1)
    for _ in range(4):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, max(4, min(w, h) / 3))
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 5, img.shape)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


# name → (width, height, PIL save options, mode)
CASES = {
    "420": (97, 75, {"quality": 90, "subsampling": 2}, "RGB"),
    "444": (90, 70, {"quality": 90, "subsampling": 0}, "RGB"),
    "422": (81, 66, {"quality": 85, "subsampling": 1}, "RGB"),
    "progressive": (88, 72, {"quality": 90, "progressive": True}, "RGB"),
    "gray": (70, 95, {"quality": 90}, "L"),
    "odd": (67, 101, {"quality": 80, "subsampling": 2}, "RGB"),
    "smaller": (40, 30, {"quality": 90, "subsampling": 2}, "RGB"),  # upsampled to SIZE
}


def _write_case(path: Path, case: str, seed: int = 0):
    w, h, opts, mode = CASES[case]
    _scene(w, h, seed).convert(mode).save(path, "JPEG", **opts)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A flat folder and a class-per-subdirectory folder, each with every case and one PNG."""
    root = tmp_path_factory.mktemp("folders")
    flat = root / "flat"
    flat.mkdir()
    for i, case in enumerate(CASES):
        _write_case(flat / f"{i}_{case}.jpg", case, seed=i)
    _scene(50, 40).save(flat / "z_other.png")
    classes = root / "classes"
    for c, cls in enumerate(("birds", "cats", "ants")):
        (classes / cls).mkdir(parents=True)
        for i, case in enumerate(list(CASES)[c::3]):
            _write_case(classes / cls / f"{case}.JPEG", case, seed=10 * c + i)
    _scene(30, 30).save(classes / "cats" / "extra.png")
    (classes / "cats" / "notes.txt").write_text("not an image")
    return {"flat": flat, "classes": classes}


@pytest.mark.parametrize("layout", ["flat", "classes"])
def test_sample_list_labels_and_name_match_jax(folders, layout):
    """Dataset indices key every cache: the listing (PNG included), labels, classes and name are the JAX package's."""
    t = ImageFolder(folders[layout], image_size=SIZE, device="cpu")
    j = JFolder(folders[layout], image_size=SIZE, decoder="pil")
    assert t.samples == j.samples and len(t) == len(j)
    assert t.class_to_idx == j.class_to_idx and t.name == j.name == layout
    assert any(p.suffix == ".png" for p, _ in t.samples)
    assert ImageFolder(folders[layout], device="cpu", name="custom").name == "custom"


@pytest.mark.parametrize("case", list(CASES))
def test_full_resolution_decode_equals_pil(tmp_path, case):
    """libjpeg's planes through planes_to_rgb (fancy chroma upsampling, fixed-point YCbCr) equal PIL: atol 0."""
    path = tmp_path / f"{case}.jpg"
    _write_case(path, case)
    ours = native_decoder.decode_cpu(path.read_bytes(), str(path))
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert ours.dtype == torch.uint8 and ours.shape == pil.shape
    np.testing.assert_array_equal(ours.numpy(), pil)


@pytest.mark.parametrize("w, h, subsampling", [(2, 2, 2), (3, 7, 2), (5, 3, 1), (17, 9, 2), (4, 4, 0)])
def test_planes_to_rgb_at_tiny_and_odd_sizes(w, h, subsampling):
    """Chroma planes of width ≤ 2 take libjpeg's box upsampling; odd sizes crop the upsampled planes."""
    img = np.random.default_rng(w * h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=75, subsampling=subsampling)
    data = buf.getvalue()
    np.testing.assert_array_equal(native_decoder.decode_cpu(data).numpy(),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("layout", ["flat", "classes"])
def test_cpu_images_within_one_level_of_jax_pil(folders, layout):
    """Every sample, JPEG and PNG (getitem and get_batch), within 1 level of ``ImageFolder(decoder="pil")``."""
    t = ImageFolder(folders[layout], image_size=SIZE, device="cpu")
    j = JFolder(folders[layout], image_size=SIZE, decoder="pil")
    jpeg = [i for i, (p, _) in enumerate(t.samples) if p.suffix.lower() in (".jpg", ".jpeg")]
    for i in range(len(t)):
        image, label = t[i]
        want, want_label = j[i]
        assert image.shape == want.shape == (SIZE, SIZE, 3) and image.dtype == np.uint8 and label == want_label
        assert np.abs(image.astype(int) - want.astype(int)).max() <= 1, t.samples[i][0].name
    block = t.get_batch(jpeg[0], jpeg[0] + 3)
    assert isinstance(block, torch.Tensor) and block.device.type == "cpu" and block.shape == (3, SIZE, SIZE, 3)
    for k in range(3):
        np.testing.assert_array_equal(block[k].numpy(), t[jpeg[0] + k][0])


def test_fixtures_equal_jax_pil_arrays():
    """The committed fixtures' reference arrays are what the JAX package's PIL path gives today, exactly,
    and the port's CPU decode stays within one level of them."""
    ref = np.load(FIXTURES / "pil_224.npz")
    j = JFolder(FIXTURES, image_size=224, decoder="pil")
    t = ImageFolder(FIXTURES, image_size=224, device="cpu")
    assert sorted(ref.files) == sorted(p.name for p, _ in j.samples) and len(j) == 6
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 2**20
    for i, (path, _) in enumerate(j.samples):
        np.testing.assert_array_equal(j[i][0], ref[path.name])
        assert np.abs(t[i][0].astype(int) - ref[path.name].astype(int)).max() <= 1, path.name


def test_non_jpeg_corrupt_truncated_and_cmyk_raise_naming_the_file(folders, tmp_path):
    """Garbage and truncated files raise naming the file; the PNG and the CMYK JPEG, which PIL decodes in
    the JAX package, decode to PIL's array at full resolution and within one level of it after the resize."""
    t = ImageFolder(folders["flat"], image_size=SIZE, device="cpu")
    j = JFolder(folders["flat"], image_size=SIZE, decoder="pil")
    png = next(i for i, (p, _) in enumerate(t.samples) if p.suffix == ".png")
    png_path = t.samples[png][0]
    np.testing.assert_array_equal(image_decode.decode(png_path.read_bytes(), str(png_path), "cpu").numpy(),
                                  np.asarray(Image.open(png_path).convert("RGB")))
    assert np.abs(t[png][0].astype(int) - j[png][0].astype(int)).max() <= 1
    good = (folders["flat"] / "0_420.jpg").read_bytes()
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "a_garbage.jpg").write_bytes(b"not a jpeg at all" * 20)
    (tmp_path / "bad" / "b_truncated.jpg").write_bytes(good[: len(good) // 2])
    _scene(40, 30).convert("CMYK").save(tmp_path / "bad" / "c_cmyk.jpg", "JPEG")
    bad = ImageFolder(tmp_path / "bad", image_size=SIZE, device="cpu")
    for i, stem in enumerate(("a_garbage", "b_truncated")):
        with pytest.raises(ValueError, match=stem):
            bad[i]
    cmyk = tmp_path / "bad" / "c_cmyk.jpg"
    np.testing.assert_array_equal(native_decoder.decode_cpu(cmyk.read_bytes(), str(cmyk)).numpy(),
                                  np.asarray(Image.open(cmyk).convert("RGB")))
    want = JFolder(tmp_path / "bad", image_size=SIZE, decoder="pil")[2][0]
    assert np.abs(bad[2][0].astype(int) - want.astype(int)).max() <= 1


def _with_exif_thumbnail(jpeg: bytes, thumbnail: bytes) -> bytes:
    """``jpeg`` with an APP1 EXIF segment after SOI whose IFD1 carries ``thumbnail``, a whole JPEG (EOI too)."""
    tiff = (b"II*\x00" + struct.pack("<IHI", 8, 0, 14)  # IFD0 at 8: no entries, IFD1 next at 14
            + struct.pack("<HHHIIHHIII", 2, 0x0201, 4, 1, 44, 0x0202, 4, 1, len(thumbnail), 0) + thumbnail)
    payload = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", 2 + len(payload)) + payload + jpeg[2:]


def _thumbnail_bearing(seed=0):
    """(whole, truncated in its scan) bytes of a PIL-written JPEG whose EXIF thumbnail holds an EOI marker."""
    main, thumb = io.BytesIO(), io.BytesIO()
    _scene(97, 75, seed).save(main, "JPEG", quality=90)
    _scene(32, 24, seed + 1).save(thumb, "JPEG", quality=80)
    whole = _with_exif_thumbnail(main.getvalue(), thumb.getvalue())
    scan = whole.rfind(b"\xff\xda")
    return whole, whole[: scan + (len(whole) - scan) // 2]


@pytest.mark.parametrize("case", list(CASES))
def test_check_complete_accepts_whole_files(tmp_path, case):
    """The card's check before nvJPEG passes every whole file, progressive (many scans) included."""
    path = tmp_path / f"{case}.jpg"
    _write_case(path, case)
    native_decoder.check_complete(path.read_bytes(), str(path))


def test_truncated_file_with_thumbnail_is_refused(tmp_path):
    """A truncated camera-style file still holds an EOI marker (its thumbnail's): the card's check and the
    CPU decoder refuse it, as PIL does in the JAX package; the whole file decodes as PIL decodes it."""
    whole, truncated = _thumbnail_bearing()
    assert truncated.rfind(b"\xff\xd9") > 0  # an EOI anywhere is no proof of a whole file
    native_decoder.check_complete(whole)
    np.testing.assert_array_equal(native_decoder.decode_cpu(whole).numpy(),
                                  np.asarray(Image.open(io.BytesIO(whole)).convert("RGB")))
    with pytest.raises(OSError):
        Image.open(io.BytesIO(truncated)).convert("RGB")
    with pytest.raises(native_decoder.JpegError, match="cut.jpg: truncated"):
        native_decoder.check_complete(truncated, "cut.jpg")
    (tmp_path / "cut.jpg").write_bytes(truncated)
    with pytest.raises(native_decoder.JpegError, match="cut.jpg"):
        ImageFolder(tmp_path, image_size=SIZE, device="cpu")[0]
    for junk in (b"", b"\xff\xd8", b"\x89PNG\r\n", whole[:40]):
        with pytest.raises(native_decoder.JpegError):
            native_decoder.check_complete(junk)


def test_decoder_argument(folders, monkeypatch):
    """The device decides the decoder (libjpeg on the CPU, nvJPEG on the card): there is no argument."""
    with pytest.raises(TypeError, match="decoder"):
        ImageFolder(folders["flat"], decoder="cpu", device="cpu")
    ds = ImageFolder(folders["flat"], image_size=SIZE, device="cpu")
    block = ds.get_batch(0, 2)
    assert block.device.type == "cpu" and not hasattr(ds._local, "decoder")  # libjpeg: no nvJPEG handle made
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageFolder(folders["flat"])  # the default device is the card


def test_iter_batches_threaded_and_padded(folders):
    """ImageFolder streams its own batches from a worker thread; the short last batch is zero-padded."""
    sub = ImageFolder(folders["flat"], image_size=SIZE, device="cpu")
    sub.samples = sub.samples[:7]  # the seven JPEG cases, not the PNG
    batches = list(iter_batches(sub, 3))
    assert [b.start_index for b in batches] == [0, 3, 6]
    assert [b.valid.tolist() for b in batches][-1] == [True, False, False]
    stacked = torch.cat([b.images for b in batches])
    assert torch.equal(stacked[:7], sub.get_batch(0, 7))
    assert not stacked[7:].any() and all(b.ready is None for b in batches)


class _TensorBatches:
    """A dataset whose ``get_batch`` returns tensors (as a decode on the card does)."""

    def __init__(self, images):
        self.data = torch.from_numpy(images)
        self.calls = []

    def __len__(self):
        return len(self.data)

    def get_batch(self, start, stop):
        out = self.data[start:stop] + 0
        self.calls.append(out)
        return out


def test_tensor_batches_pass_through_and_pad_as_tensors():
    """A tensor from ``get_batch`` is not turned into numpy; the last batch is padded with torch."""
    images = np.random.default_rng(0).integers(0, 256, (7, 4, 4, 3), dtype=np.uint8)
    ds = _TensorBatches(images)
    batches = list(iter_batches(ds, 3))
    assert all(isinstance(b.images, torch.Tensor) for b in batches)
    assert batches[0].images is ds.calls[0]  # full batches are the tensor itself
    assert batches[-1].images.shape == (3, 4, 4, 3) and batches[-1].valid.tolist() == [True, False, False]
    np.testing.assert_array_equal(torch.cat([b.images for b in batches])[:7].numpy(), images)
    assert not batches[-1].images[1:].any()
    out = list(device_prefetch_batches(iter(batches), torch.device("cpu")))
    assert [s for _, s, _ in out] == [0, 3, 6]
    np.testing.assert_array_equal(out[1][0].numpy(), images[3:6])
    # the host path keeps working
    host = list(iter_batches(ArrayDataset(images), 3))
    assert all(isinstance(b.images, np.ndarray) for b in host)
