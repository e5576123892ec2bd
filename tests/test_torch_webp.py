"""Port parity of WebP decoding against PIL, the JAX package's decoder.

The JAX ``ImageFolder`` and upload decode WebP with
``np.asarray(Image.open(f).convert("RGB"))`` (libwebp's animation decoder
under Pillow); :func:`semanticlens_tpu_torch.data.image_decode.decode` must
give that array exactly at full resolution, and raise
:class:`~semanticlens_tpu_torch.data.raw.DecodeError` naming the file where
PIL raises. Files PIL writes cover its options (lossless methods and
qualities, palettes, lossy qualities and methods, alpha, metadata,
animations); ``tests/data/torch_formats/webp_recipe_*`` cover the encoder
settings PIL cannot choose (simple filter, sharpness, filter strength,
segments, token partitions, raw alpha); the helpers below assemble
containers, ``ALPH`` chunks with each filter and damaged files by hand.
"""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from semanticlens_tpu.data.image_folder import ImageFolder as JFolder
from semanticlens_tpu_torch.data import ImageFolder, image_decode, iter_batches, webp
from semanticlens_tpu_torch.data.raw import DecodeError

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_formats"
SIZE = 48  # image_size of the folder case


def _pil(data: bytes, mode: str = "RGB") -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


def _decode(data: bytes, name: str = "case.webp") -> np.ndarray:
    out = image_decode.decode(data, name, "cpu")
    assert out.dtype == torch.uint8 and out.device.type == "cpu" and out.ndim == 3 and out.shape[2] == 3
    return out.numpy()


def _assert_like_pil(data: bytes, name: str = "case.webp") -> str:
    """Equal to PIL's array where PIL decodes the file; a DecodeError naming the file where PIL raises."""
    try:
        want = _pil(data)
    except Exception:  # whatever PIL raises for the file
        with pytest.raises(DecodeError, match=name.replace(".", r"\.")):
            image_decode.decode(data, name, "cpu")
        return "raises"
    np.testing.assert_array_equal(_decode(data, name), want, err_msg=name)
    return "decodes"


def _assert_alpha_like_pil(data: bytes):
    """The ALPH chunk decodes to PIL's alpha channel (the port checks it and then drops it)."""
    header = webp.read_header(data, "alpha")
    alph = header.alpha()
    assert alph is not None
    got = webp.decode_alpha(alph, header.frame.width, header.frame.height, "alpha")
    np.testing.assert_array_equal(got, _pil(data, "RGBA")[..., 3])


def _scene(h: int, w: int, seed: int, noise: float = 6.0) -> np.ndarray:
    """(h, w, 3) uint8: gradients, a disc and a texture, plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    rgb = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1), 128 + 90 * np.sin((x + 2 * y) / 7)], -1)
    rgb[(x - w / 3) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 4) ** 2] = rng.integers(0, 256, 3)
    rgb += ((x // 3 + y // 2) % 4)[..., None] * 9 + rng.normal(0, noise, rgb.shape)
    return rgb.round().clip(0, 255).astype(np.uint8)


def _alpha(h: int, w: int) -> np.ndarray:
    """A ramp with a transparent band on top."""
    y, x = np.mgrid[:h, :w]
    return np.where(y < h // 4, 0, 255 * x // max(w - 1, 1)).astype(np.uint8)


def _save(array: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "WEBP", **kwargs)
    return buf.getvalue()


# --------------------------------------------------------------------------- #
# Containers by hand
# --------------------------------------------------------------------------- #
def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes, size: int | None = None) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body) if size is None else size) + body


def chunks_of(data: bytes) -> list[tuple[bytes, bytes]]:
    """(fourcc, payload) of each top-level chunk of a well-formed file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        fourcc, n = struct.unpack("<4sI", data[pos : pos + 8])
        out.append((fourcc, data[pos + 8 : pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def payload(data: bytes, fourcc: bytes) -> bytes:
    return next(p for f, p in chunks_of(data) if f == fourcc)


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def anmf(x: int, y: int, w: int, h: int, *frame_chunks: bytes, flags: int = 0) -> bytes:
    head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (w - 1).to_bytes(3, "little")
    head += (h - 1).to_bytes(3, "little") + (80).to_bytes(3, "little") + bytes([flags])
    return chunk(b"ANMF", head + b"".join(frame_chunks))


ANIM = chunk(b"ANIM", b"\xff\xff\xff\xff\x00\x00")
ALPHA, ANIMATION, ICCP, EXIF, XMP = 0x10, 0x02, 0x20, 0x08, 0x04


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters (none, horizontal, vertical, gradient) as the decoder undoes them."""
    a = alpha.astype(np.int32)
    if method == 0:
        return alpha.copy()
    pred = np.zeros_like(a)
    if method == 1:
        pred[:, 1:] = a[:, :-1]
        pred[1:, 0] = a[:-1, 0]
    elif method == 2:
        pred[1:] = a[:-1]
        pred[0, 1:] = a[0, :-1]
    else:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int, lossless: bool) -> bytes:
    """An ALPH chunk: raw bytes or a header-less VP8L stream (PIL's lossless encoding of the filtered
    plane as gray, whose 5-byte header ends on a byte boundary) carrying ``alpha`` under ``method``."""
    plane = alpha_filter(alpha, method)
    if not lossless:
        return chunk(b"ALPH", bytes([method << 2]) + plane.tobytes())
    stream = payload(_save(np.repeat(plane[..., None], 3, axis=2), lossless=True), b"VP8L")[5:]
    return chunk(b"ALPH", bytes([1 | method << 2]) + stream)


# --------------------------------------------------------------------------- #
# Lossless (VP8L)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", range(7))
def test_vp8l_every_method_and_quality_equals_pil(method, quality):
    """PIL's lossless methods 0–6 and qualities pick different transform sets, colour caches and meta codes."""
    data = _save(_scene(29, 41, method), lossless=True, method=method, quality=quality)
    assert payload(data, b"VP8L")[0] == 0x2F
    assert _assert_like_pil(data) == "decodes"


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_vp8l_palettes_of_every_bundling_width(colours):
    """≤ 2, ≤ 4, ≤ 16 colours pack 8, 4 and 2 pixels per coded pixel; more are one each."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    image = palette[rng.integers(0, colours, (23, 37))]
    for method in (0, 4, 6):
        assert _assert_like_pil(_save(image, lossless=True, method=method)) == "decodes"


@pytest.mark.parametrize("w, h", [(1, 1), (3, 1), (1, 7), (17, 33), (257, 3)])
def test_vp8l_sizes(w, h):
    for seed, noise in ((0, 0.0), (1, 40.0)):
        assert _assert_like_pil(_save(_scene(h, w, seed, noise), lossless=True)) == "decodes"


def test_vp8l_exact_keeps_rgb_under_transparent_pixels():
    rgb = _scene(19, 27, 3)
    rgba = np.dstack([rgb, _alpha(19, 27)])
    data = _save(rgba, lossless=True, exact=True)
    got = _decode(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, rgb)  # RGB at alpha 0 kept, not zeroed or premultiplied
    loose = _save(rgba, lossless=True)  # without exact, libwebp may rewrite them; PIL's array is still the judge
    assert _assert_like_pil(loose) == "decodes"


# --------------------------------------------------------------------------- #
# Lossy (VP8)
# --------------------------------------------------------------------------- #
def _content(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    if kind == "flat":  # skipped macroblocks, DC only
        return np.full((h, w, 3), (90, 140, 200), np.uint8)
    if kind == "smooth":
        return _scene(h, w, seed, noise=2.0)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)  # B_PRED, large tokens


@pytest.mark.parametrize("kind", ["flat", "smooth", "noisy"])
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 5, 50, 75, 95, 100])
def test_vp8_quality_method_and_content_equal_pil(quality, method, kind):
    data = _save(_content(kind, 37, 45, quality + method), quality=quality, method=method)
    assert payload(data, b"VP8 ")[3:6] == b"\x9d\x01\x2a"
    assert _assert_like_pil(data) == "decodes"


@pytest.mark.parametrize("w, h", [(1, 1), (15, 17), (16, 16), (17, 15), (33, 31), (2, 2), (1, 6)])
def test_vp8_sizes_and_the_upsamplers_edges(w, h):
    """Odd and even sizes: the fancy upsampler's last column and row, and partial macroblocks."""
    for kind in ("smooth", "noisy"):
        assert _assert_like_pil(_save(_content(kind, h, w, w * h), quality=70)) == "decodes"


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("webp_recipe_*.webp")))
def test_recipe_fixtures_equal_pil(name):
    """Encoder settings PIL cannot choose, written by webp_recipes.cpp: the simple loop filter, sharpness,
    filter strength 0 and 100, one and four segments, 2/4/8 token partitions, raw and compressed alpha."""
    data = (FIXTURES / name).read_bytes()
    assert _assert_like_pil(data, name) == "decodes"
    if "alpha" in name:
        _assert_alpha_like_pil(data)


def test_recipe_fixtures_carry_their_settings():
    """The recipe files hold what their names say: n token partitions (n − 1 three-byte sizes after the
    first partition, which the rest of the chunk holds), raw or lossless alpha in the ALPH header."""
    for n in (2, 4, 8):
        vp8 = payload((FIXTURES / f"webp_recipe_partitions{n}_96x136.webp").read_bytes(), b"VP8 ")
        rest = vp8[10 + (int.from_bytes(vp8[:3], "little") >> 5) :]
        sizes = [int.from_bytes(rest[3 * i : 3 * i + 3], "little") for i in range(n - 1)]
        assert min(sizes) > 0 and sum(sizes) < len(rest) - 3 * (n - 1), (n, sizes, len(rest))
    for name, method in (("alpha_raw", 0), ("alpha_lossless_nofilter", 1), ("alpha_lossless_filter_best", 1)):
        alph = payload((FIXTURES / f"webp_recipe_{name}_67x45.webp").read_bytes(), b"ALPH")
        assert alph[0] & 3 == method


@pytest.mark.parametrize("alpha_quality", [100, 50])
def test_lossy_with_alpha_equals_pil(alpha_quality):
    rgba = np.dstack([_scene(33, 47, alpha_quality), _alpha(33, 47)])
    data = _save(rgba, quality=80, alpha_quality=alpha_quality)
    assert chunks_of(data)[0][0] == b"VP8X" and any(f == b"ALPH" for f, _ in chunks_of(data))
    assert _assert_like_pil(data) == "decodes"
    _assert_alpha_like_pil(data)


@pytest.mark.parametrize("lossless", [False, True], ids=["raw", "lossless"])
@pytest.mark.parametrize("method", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_alph_every_filter_raw_and_compressed(method, lossless):
    """ALPH chunks written here with each filter, raw and VP8L-compressed, around a PIL lossy frame."""
    h, w = 21, 34
    alpha = (_scene(h, w, 9)[..., 1] // 3 + _alpha(h, w) // 2).astype(np.uint8)
    vp8 = chunk(b"VP8 ", payload(_save(_scene(h, w, 8), quality=60), b"VP8 "))
    data = riff(vp8x(ALPHA, w, h), alph_chunk(alpha, method, lossless), vp8)
    assert _assert_like_pil(data) == "decodes"
    _assert_alpha_like_pil(data)
    np.testing.assert_array_equal(_pil(data, "RGBA")[..., 3], alpha)


# --------------------------------------------------------------------------- #
# Extended format, animations, container rules
# --------------------------------------------------------------------------- #
def test_vp8x_with_icc_exif_xmp_and_unknown_chunks():
    image = _scene(26, 30, 4)
    for kwargs in ({"quality": 80}, {"lossless": True}):
        data = _save(image, icc_profile=b"\0" * 131, exif=b"Exif\0\0" + b"\1" * 33, xmp=b"<x:xmpmeta/>", **kwargs)
        tags = [f for f, _ in chunks_of(data)]
        assert tags[0] == b"VP8X" and {b"ICCP", b"EXIF", b"XMP "} <= set(tags)
        assert _assert_like_pil(data) == "decodes"
        # an odd-sized unknown chunk (padded) before the image and one after it are skipped
        parts = [chunk(f, p) for f, p in chunks_of(data)]
        assert _assert_like_pil(riff(parts[0], chunk(b"ZZZZ", b"abc"), *parts[1:], chunk(b"TAIL", b"x"))) == "decodes"


@pytest.mark.parametrize("kwargs", [{"lossless": True}, {"quality": 70}, {"allow_mixed": True}],
                         ids=["lossless", "lossy", "mixed"])
def test_pil_animations_give_their_first_frame(kwargs):
    frames = [Image.fromarray(_scene(27, 35, seed)) for seed in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50, **kwargs)
    data = buf.getvalue()
    assert Image.open(io.BytesIO(data)).n_frames == 3
    assert _assert_like_pil(data) == "decodes"


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy-alpha"])
def test_assembled_animation_smaller_first_frame_at_an_offset(kind):
    """ANIM + ANMF frames written here: a 13×9 first frame at (6, 4) on a 31×23 canvas, RGB 0 around it."""
    fw, fh = 13, 9
    image = _scene(fh, fw, 5)
    if kind == "lossless":
        first = [chunk(b"VP8L", payload(_save(image, lossless=True), b"VP8L"))]
    else:
        first = [chunk(b"VP8 ", payload(_save(image, quality=75), b"VP8 "))]
        if kind == "lossy-alpha":
            first.insert(0, alph_chunk(_alpha(fh, fw), 3, True))
    second = chunk(b"VP8L", payload(_save(_scene(23, 31, 6), lossless=True), b"VP8L"))
    data = riff(vp8x(ANIMATION | ALPHA, 31, 23), ANIM, anmf(6, 4, fw, fh, *first), anmf(0, 0, 31, 23, second))
    got = _decode(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert got.shape == (23, 31, 3) and not got[:4].any() and not got[:, :6].any() and not got[13:].any()
    # the frame's size is its bitstream's: an ANMF that declares another is decoded as PIL decodes it
    odd = riff(vp8x(ANIMATION, 31, 23), ANIM, anmf(6, 4, fw + 3, fh + 1, *first[-1:]))
    assert _assert_like_pil(odd) == "decodes"


def _simple(kind: str = "lossy") -> bytes:
    image = _scene(10, 14, 2)
    return _save(image, lossless=True) if kind == "lossless" else _save(image, quality=70)


def _container_cases() -> dict[str, bytes]:
    lossy, lossless = _simple(), _simple("lossless")
    vp8, vp8l = chunk(b"VP8 ", payload(lossy, b"VP8 ")), chunk(b"VP8L", payload(lossless, b"VP8L"))
    alph = alph_chunk(_alpha(10, 14), 1, True)
    broken_alph = chunk(b"ALPH", b"\x01\xff\xff")
    frame = anmf(0, 0, 14, 10, vp8)
    return {
        "trailing-bytes-past-riff": lossy + b"junk after the RIFF chunk",
        "riff-size-past-the-data": lossy[:4] + struct.pack("<I", len(lossy) - 8 + 2) + lossy[8:],
        "riff-size-short": lossy[:4] + struct.pack("<I", len(lossy) - 8 - 6) + lossy[8:],
        "riff-size-odd": lossy[:4] + struct.pack("<I", len(lossy) - 8 + 1) + lossy[8:] + b"\0",
        "riff-size-tiny": lossy[:4] + struct.pack("<I", 4) + lossy[8:],
        "short-file": lossy[:18],
        "simple-then-unknown": riff(vp8, chunk(b"ABCD", b"12345")),
        "simple-then-few-bytes": riff(vp8, b"\0" * 4),
        "simple-then-alph": riff(vp8, broken_alph),
        "first-chunk-unknown": riff(chunk(b"ABCD", b"12"), vp8),
        "vp8x-alpha-flag": riff(vp8x(ALPHA, 14, 10), alph, vp8),
        "vp8x-alph-without-flag": riff(vp8x(0, 14, 10), broken_alph, vp8),
        "vp8x-broken-alph": riff(vp8x(ALPHA, 14, 10), broken_alph, vp8),
        "vp8x-empty-alph": riff(vp8x(ALPHA, 14, 10), chunk(b"ALPH", b""), vp8),
        "vp8x-alph-after-image": riff(vp8x(ALPHA, 14, 10), vp8, alph),
        "vp8x-alph-then-vp8l": riff(vp8x(ALPHA, 14, 10), alph, vp8l),
        "vp8x-two-alph": riff(vp8x(ALPHA, 14, 10), alph, alph, vp8),
        "vp8x-alph-unknown-vp8": riff(vp8x(ALPHA, 14, 10), alph, chunk(b"ABCD", b""), vp8),
        "vp8x-canvas-mismatch": riff(vp8x(0, 15, 10), vp8),
        "vp8x-reserved-flag": riff(vp8x(0x01, 14, 10), vp8),
        "vp8x-no-image": riff(vp8x(0, 14, 10), chunk(b"EXIF", b"x")),
        "vp8x-two-images": riff(vp8x(0, 14, 10), vp8, vp8),
        "vp8x-second-vp8x": riff(vp8x(0, 14, 10), vp8x(0, 14, 10), vp8),
        "vp8x-short-chunk": riff(chunk(b"VP8X", b"\0" * 9), vp8),
        "vp8x-long-chunk": riff(chunk(b"VP8X", b"\0" * 4 + (13).to_bytes(3, "little") + (9).to_bytes(3, "little")
                                      + b"pad!"), vp8),
        "vp8x-trailing-few-bytes": riff(vp8x(0, 14, 10), vp8, b"abc\0"),
        "vp8x-lossless": riff(vp8x(ALPHA, 14, 10), vp8l),
        "anim-flag-still-image": riff(vp8x(ANIMATION, 14, 10), ANIM, vp8),
        "anim-no-anim-chunk": riff(vp8x(ANIMATION, 14, 10), frame),
        "anim-no-frames": riff(vp8x(ANIMATION, 14, 10), ANIM),
        "anmf-without-flag": riff(vp8x(0, 14, 10), ANIM, frame),
        "anim-frame-outside-canvas": riff(vp8x(ANIMATION, 14, 10), ANIM, anmf(2, 0, 14, 10, vp8)),
        "anim-two-anim-chunks": riff(vp8x(ANIMATION, 14, 10), ANIM, ANIM, frame),
        "anim-short-anim-chunk": riff(vp8x(ANIMATION, 14, 10), chunk(b"ANIM", b"\0" * 4), frame),
        "anim-empty-frame": riff(vp8x(ANIMATION, 14, 10), ANIM, anmf(0, 0, 14, 10), frame),
        "anim-unknown-in-frame": riff(vp8x(ANIMATION, 14, 10), ANIM, anmf(0, 0, 14, 10, vp8, chunk(b"ABCD", b"x"))),
        "anim-broken-second-header": riff(vp8x(ANIMATION, 14, 10), ANIM, frame,
                                          anmf(0, 0, 14, 10, chunk(b"VP8 ", b"\0" * 12))),
        "anim-second-frame-outside": riff(vp8x(ANIMATION, 14, 10), ANIM, frame, anmf(4, 0, 14, 10, vp8)),
        "vp8-not-key-frame": riff(chunk(b"VP8 ", bytes([payload(lossy, b"VP8 ")[0] | 1]) + payload(lossy, b"VP8 ")[1:])),
        "vp8-bad-start-code": riff(chunk(b"VP8 ", payload(lossy, b"VP8 ")[:3] + b"\x9d\x01\x2b"
                                        + payload(lossy, b"VP8 ")[6:])),
        "vp8-zero-width": riff(chunk(b"VP8 ", payload(lossy, b"VP8 ")[:6] + b"\0\0" + payload(lossy, b"VP8 ")[8:])),
        "vp8-short": riff(chunk(b"VP8 ", payload(lossy, b"VP8 ")[:9])),
        "vp8l-bad-signature": riff(chunk(b"VP8L", b"\x2e" + payload(lossless, b"VP8L")[1:])),
        "vp8l-version-1": riff(chunk(b"VP8L", payload(lossless, b"VP8L")[:4] + bytes([payload(lossless, b"VP8L")[4]
                                                                                      | 0x20])
                                     + payload(lossless, b"VP8L")[5:])),
        "vp8l-short": riff(chunk(b"VP8L", payload(lossless, b"VP8L")[:4])),
    }


@pytest.mark.parametrize("case", sorted(_container_cases()))
def test_container_rules_follow_pil(case):
    _assert_like_pil(_container_cases()[case], f"{case}.webp")


def test_container_rules_include_both_outcomes():
    outcomes = {case: _assert_like_pil(data, f"{case}.webp") for case, data in _container_cases().items()}
    assert outcomes["trailing-bytes-past-riff"] == outcomes["vp8x-alph-without-flag"] == "decodes"
    assert outcomes["riff-size-past-the-data"] == outcomes["vp8x-canvas-mismatch"] == "raises"
    assert outcomes["vp8x-broken-alph"] == outcomes["anim-broken-second-header"] == "raises"
    assert 10 < sum(o == "raises" for o in outcomes.values()) < len(outcomes) - 5


# --------------------------------------------------------------------------- #
# Damaged files
# --------------------------------------------------------------------------- #
def _damage_sources() -> dict[str, tuple[bytes, bytes, int, int]]:
    """name → (file, fourcc of the damaged chunk, first and last offset of the damaged span in the file)."""
    rgba = np.dstack([_scene(40, 52, 1), _alpha(40, 52)])
    lossy_alpha = _save(rgba, quality=75, alpha_quality=100)
    lossless = _save(_scene(40, 52, 2, noise=12.0), lossless=True, method=4)
    spans = {}

    def span(data, fourcc):
        pos = 12
        while True:
            f, n = struct.unpack("<4sI", data[pos : pos + 8])
            if f == fourcc:
                return pos + 8, n
            pos += 8 + n + (n & 1)

    start, n = span(lossy_alpha, b"VP8 ")
    first = int.from_bytes(lossy_alpha[start : start + 3], "little") >> 5
    spans["vp8-first-partition"] = (lossy_alpha, start + 10, start + 10 + first)
    spans["vp8-token-partitions"] = (lossy_alpha, start + 10 + first, start + n)
    start, n = span(lossy_alpha, b"ALPH")
    spans["alph"] = (lossy_alpha, start, start + n)
    start, n = span(lossless, b"VP8L")
    spans["vp8l"] = (lossless, start + 5, start + n)
    return spans


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("where", ["vp8-first-partition", "vp8-token-partitions", "alph", "vp8l"])
def test_seeded_byte_flips_follow_pil(where, seed):
    data, lo, hi = _damage_sources()[where]
    rng = np.random.default_rng(100 * seed + len(where))
    outcomes = []
    for _ in range(25):
        damaged = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            damaged[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
        outcomes.append(_assert_like_pil(bytes(damaged), f"{where}.webp"))
    assert outcomes.count("decodes") + outcomes.count("raises") == 25


@pytest.mark.parametrize("where", ["vp8-first-partition", "vp8-token-partitions", "alph", "vp8l"])
def test_bitstreams_cut_inside_a_valid_container_follow_pil(where):
    """A chunk whose payload was cut (its size and the RIFF size rewritten): libwebp's end-of-data rules
    decide, per bitstream, whether the frame fails."""
    data, lo, hi = _damage_sources()[where]
    parts = chunks_of(data)
    fourcc = {"alph": b"ALPH", "vp8l": b"VP8L"}.get(where, b"VP8 ")
    body = dict(parts)[fourcc]
    base = data.index(body)  # the payload's offset in the file
    cuts = {int(c) for c in np.linspace(lo - base, hi - base, 12)} | {len(body) - 1, len(body) - 2, len(body) - 3}
    outcomes = set()
    for cut in sorted(c for c in cuts if c > 0):
        rebuilt = riff(*(chunk(f, body[:cut] if f == fourcc else p) for f, p in parts))
        outcomes.add(_assert_like_pil(rebuilt, f"{where}-cut{cut}.webp"))
    assert "raises" in outcomes


@pytest.mark.parametrize("cut", [1, 12, 20, 40, 0.5, -1])
def test_truncated_files_follow_pil(cut):
    for data in (_simple(), _simple("lossless"), _save(np.dstack([_scene(9, 9, 3), _alpha(9, 9)]), quality=60)):
        n = int(len(data) * cut) if isinstance(cut, float) else (len(data) + cut if cut < 0 else cut)
        assert _assert_like_pil(data[:n], "cut.webp") == "raises"


# --------------------------------------------------------------------------- #
# The conversion on the device
# --------------------------------------------------------------------------- #
def _line_pair(top_y, bottom_y, top_u, cur_u, width):
    """A transcription of libwebp's UpsampleRgbLinePair for one chroma plane (the U or V lane alike):
    the upsampled chroma of the top row and of the bottom row (None without one)."""
    top, bottom = [0] * width, [0] * width if bottom_y else None
    tl, l = top_u[0], cur_u[0]
    top[0] = (3 * tl + l + 2) >> 2
    if bottom is not None:
        bottom[0] = (3 * l + tl + 2) >> 2
    for x in range(1, (width - 1) // 2 + 1):
        t, uv = top_u[x], cur_u[x]
        avg = tl + t + l + uv + 8
        d12, d03 = (avg + 2 * (t + l)) >> 3, (avg + 2 * (tl + uv)) >> 3
        top[2 * x - 1], top[2 * x] = (d12 + tl) >> 1, (d03 + t) >> 1
        if bottom is not None:
            bottom[2 * x - 1], bottom[2 * x] = (d03 + l) >> 1, (d12 + uv) >> 1
        tl, l = t, uv
    if width % 2 == 0:
        top[width - 1] = (3 * tl + l + 2) >> 2
        if bottom is not None:
            bottom[width - 1] = (3 * l + tl + 2) >> 2
    return top, bottom


def _fancy_upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's EmitFancyRGB over a whole frame: row 0 alone, then pairs, then an even height's last row."""
    out = np.zeros((height, width), np.int64)
    out[0] = _line_pair(True, False, c[0], c[0], width)[0]
    for k in range(1, (height - 1) // 2 + 1):
        top, bottom = _line_pair(True, True, c[k - 1], c[k], width)
        out[2 * k - 1], out[2 * k] = top, bottom
    if height % 2 == 0 and height > 1:
        out[height - 1] = _line_pair(True, False, c[-1], c[-1], width)[0]
    return out


@pytest.mark.parametrize("h, w", [(1, 1), (1, 2), (2, 1), (2, 2), (5, 7), (6, 8), (7, 6), (16, 33)])
def test_conversion_equals_a_transcription_of_libwebps_upsampler(h, w):
    rng = np.random.default_rng(h * 100 + w)
    uh, uw = (h + 1) // 2, (w + 1) // 2
    y = rng.integers(0, 256, (h, w))
    u, v = rng.integers(0, 256, (uh, uw)), rng.integers(0, 256, (uh, uw))
    planes = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).astype(np.uint8)
    got = webp.to_rgb(torch.from_numpy(planes), w, h).numpy().astype(np.int64)
    uu, vv = _fancy_upsample(u, h, w), _fancy_upsample(v, h, w)

    def clip8(x):
        return np.where((x & ~((256 << 6) - 1)) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    want = np.stack([clip8(yy + ((vv * 26149) >> 8) - 14234),
                     clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708),
                     clip8(yy + ((uu * 33050) >> 8) - 17685)], -1)
    np.testing.assert_array_equal(got, want)


def test_header_gives_the_canvas_before_any_pixel():
    data = riff(vp8x(ANIMATION, 31, 23), ANIM, anmf(6, 4, 13, 9, chunk(b"VP8 ", payload(_save(_scene(9, 13, 1)),
                                                                                          b"VP8 "))))
    header = webp.read_header(data, "x")
    assert (header.width, header.height) == (31, 23) and (header.frame.x, header.frame.y) == (6, 4)
    assert (header.frame.width, header.frame.height) == (13, 9) and not header.lossless
    with pytest.raises(DecodeError, match="y.webp: not a WebP"):
        webp.read_header(b"RIFF\0\0\0\0WEBX" + bytes(20), "y.webp")


def test_webp_is_chosen_by_content_under_any_name():
    data = _save(_scene(12, 20, 7), quality=60)
    assert image_decode.sniff(data) == "webp"
    np.testing.assert_array_equal(_decode(data, "photo.png"), _pil(data))
    assert webp.decode(data, "x", torch.device("cpu")).device.type == "cpu"


# --------------------------------------------------------------------------- #
# Fixtures, folders
# --------------------------------------------------------------------------- #
def test_full_width_fixtures_equal_pil():
    refs = json.loads((FIXTURES / "pil_webp_sha256.json").read_text())
    for name in ("webp_lossy_q75_500x375.webp", "webp_lossy_q90_500x375.webp", "webp_lossless_500x375.webp",
                 "webp_lossy_alpha_500x375.webp", "webp_anim_500x375.webp"):
        got = np.ascontiguousarray(_decode((FIXTURES / name).read_bytes(), name))
        assert list(got.shape) == refs[name]["shape"] == [375, 500, 3], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == refs[name]["sha256"], name


@pytest.fixture(scope="module")
def webp_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("webp_folder")
    for cls in ("ants", "bees"):
        (root / cls).mkdir()
    (root / "ants" / "a.webp").write_bytes(_save(_scene(61, 83, 1), quality=80))
    (root / "ants" / "b.webp").write_bytes(_save(_scene(50, 70, 2), lossless=True))
    (root / "ants" / "c.png").write_bytes(_save(np.dstack([_scene(57, 49, 3), _alpha(57, 49)]), quality=70))
    (root / "bees" / "d.webp").write_bytes((FIXTURES / "webp_recipe_partitions4_96x136.webp").read_bytes())
    (root / "bees" / "e.webp").write_bytes((FIXTURES / "webp_anim_500x375.webp").read_bytes())
    Image.fromarray(_scene(40, 64, 4)).save(root / "bees" / "f.png")
    return root


def test_folder_with_webp_within_one_level_of_jax_pil(webp_folder):
    """get_batch and iter_batches over WebP files (lossy, lossless, alpha, a WebP under a .png name,
    partitions, an animation) against the JAX ImageFolder(decoder="pil")."""
    t = ImageFolder(webp_folder, image_size=SIZE, device="cpu")
    j = JFolder(webp_folder, image_size=SIZE, decoder="pil")
    assert t.samples == j.samples and len(t) == 6
    want = j.get_batch(0, len(j)).astype(int)
    got = t.get_batch(0, len(t))
    assert isinstance(got, torch.Tensor) and got.shape == (len(t), SIZE, SIZE, 3)
    for i, (path, _) in enumerate(t.samples):
        assert np.abs(got[i].numpy().astype(int) - want[i]).max() <= 1, path.name
    batches = list(iter_batches(t, 4))
    assert [b.start_index for b in batches] == [0, 4]
    np.testing.assert_array_equal(torch.cat([b.images for b in batches])[: len(t)].numpy(), got.numpy())
