"""Port parity of every image format the JAX ``ImageFolder`` and upload read, against PIL.

The JAX package decodes with ``np.asarray(Image.open(f).convert("RGB"))``; the
port's :func:`semanticlens_tpu_torch.data.image_decode.decode` must give that
array exactly at full resolution, on the CPU here (PNG and BMP through the
same torch ops the card runs after its upload; JPEG through the libjpeg shim).
Files PIL cannot write (Adam7, every PNG filter type, 2-bit gray, run-length
and bit-field BMPs, other headers) are written by hand below and decoded by
PIL as the reference. Where PIL refuses a file the port raises
:class:`~semanticlens_tpu_torch.data.raw.DecodeError` naming it. A mixed
folder's batches stay within one level of the JAX ``ImageFolder(decoder="pil")``,
the bound of the JPEG path's ``test_cpu_images_within_one_level_of_jax_pil``.

The committed fixtures under ``tests/data/torch_formats`` (the card's decode
check in ``chip_smoke.py``) hold PIL's arrays in ``pil_full.npz``, and the
SHA-256 of PIL's arrays of the WebP fixtures in ``pil_webp_sha256.json``.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from semanticlens_tpu.data.image_folder import ImageFolder as JFolder
from semanticlens_tpu_torch.data import ImageFolder, bmp, image_decode, iter_batches, native_decoder, png
from semanticlens_tpu_torch.data.raw import MAX_IMAGE_PIXELS, DecodeError

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_formats"
SIZE = 48  # image_size of the folder cases


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _decode(data: bytes, name: str = "case") -> np.ndarray:
    out = image_decode.decode(data, name, "cpu")
    assert out.dtype == torch.uint8 and out.device.type == "cpu" and out.ndim == 3 and out.shape[2] == 3
    return out.numpy()


def _assert_like_pil(data: bytes, name: str):
    """Equal to PIL's array where PIL decodes the file; a DecodeError naming the file where PIL raises."""
    try:
        want = _pil(data)
    except Exception:  # whatever PIL raises for the file
        with pytest.raises(DecodeError, match=name):
            image_decode.decode(data, name, "cpu")
        return "raises"
    np.testing.assert_array_equal(_decode(data, name), want)
    return "decodes"


# --------------------------------------------------------------------------- #
# Writers for what PIL does not write
# --------------------------------------------------------------------------- #
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, N) samples → (H, ceil(N · depth / 8)) uint8 rows, most significant bits first, 16 bits big-endian."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    grouped = np.pad(samples, ((0, 0), (0, -n % per))).reshape(h, -1, per).astype(np.uint8)
    return np.bitwise_or.reduce(grouped << np.arange(8 - depth, -1, -depth, dtype=np.uint8), axis=-1)


def filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Rows of raw bytes → PNG scanlines, row r with filter type ``filters[r % len(filters)]``."""
    raw = rows.astype(np.int32)
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, : raw.shape[1]]
    up = np.vstack([np.zeros_like(raw[:1]), raw[:-1]])
    up_left = np.pad(up, ((0, 0), (bpp, 0)))[:, : raw.shape[1]]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    by_type = [raw, raw - left, raw - up, raw - (left + up) // 2, raw - paeth]
    out = bytearray()
    for r in range(raw.shape[0]):
        t = filters[r % len(filters)]
        out += bytes([t]) + (by_type[t][r] & 255).astype(np.uint8).tobytes()
    return bytes(out)


def png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def write_png(samples: np.ndarray, depth: int, colour: int, *, palette: bytes = b"", trns: bytes = b"",
              interlace: bool = False, filters=(0, 1, 2, 3, 4), idat_parts: int = 1) -> bytes:
    """(H, W, C) integer samples → PNG bytes, every scanline filtered by hand, Adam7 on request."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            stream += filter_rows(pack_samples(sub.reshape(sub.shape[0], -1), depth), bpp, filters)
    z = zlib.compress(stream, 6)
    cuts = np.linspace(0, len(z), idat_parts + 1).astype(int)
    head = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    head += png_chunk(b"PLTE", palette) if palette else b""
    head += png_chunk(b"tRNS", trns) if trns else b""
    idat = b"".join(png_chunk(b"IDAT", z[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return png.SIGNATURE + head + idat + png_chunk(b"IEND", b"")


def write_bmp(width: int, height: int, bits: int, pixels: bytes, *, header: int = 40, compression: int = 0,
              table: bytes = b"", masks: tuple = (), colors: int = 0, top_down: bool = False,
              offset: int | None = None) -> bytes:
    """A BMP file around ``pixels`` (rows as stored) with the given header size, colour table and masks."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        tail = b""
    else:
        info = struct.pack("<IIiHHIIiiII", header, width, -height if top_down else height, 1, bits, compression,
                           len(pixels), 2835, 2835, colors, 0)
        if header > 40:
            info += struct.pack(f"<{4 if header >= 56 else 3}I", *(tuple(masks) + (0,) * 4)[: 4 if header >= 56 else 3])
            info += bytes(header - len(info))
            tail = b""
        else:
            tail = struct.pack("<3I", *masks[:3]) if compression == 3 else b""
    tail += table
    start = 14 + len(info) + len(tail) if offset is None else offset
    return b"BM" + struct.pack("<IHHI", 14 + len(info) + len(tail) + len(pixels), 0, 0, start) + info + tail + pixels


def bmp_rows(rows: np.ndarray, top_down: bool = False) -> bytes:
    """(H, n) uint8 image rows → the pixel array as stored: 4-byte aligned rows, bottom-up unless top-down."""
    h, n = rows.shape
    padded = np.pad(rows, ((0, 0), (0, -n % 4)))
    return (padded if top_down else padded[::-1]).tobytes()


def rle_encode(rows: np.ndarray, rle4: bool) -> bytes:
    """Run-length rows (one palette index per entry) as BI_RLE8 / BI_RLE4: runs of 3 or more, absolute
    stretches between them (any length from 3), an end of line per row and an end of bitmap."""
    out = bytearray()
    for row in rows[::-1]:  # bottom-up
        i, n = 0, len(row)
        while i < n:
            j = i
            while j + 1 < n and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2 or n - i < 3:  # a run
                count = j - i + 1
                out += bytes([count, row[i] * 17 if rle4 else row[i]])
                i = j + 1
                continue
            k = i + 3
            while k < n and k - i < 254 and not (k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            if rle4 and (k - i) % 2:  # even stretches: PIL reads count // 2 bytes of an RLE4 stretch
                k -= 1
            if k - i < 3:
                out += bytes([1, row[i] * 17])
                i += 1
                continue
            part = row[i:k]
            body = pack_samples(part[None], 4)[0].tobytes() if rle4 else part.astype(np.uint8).tobytes()
            out += bytes([0, len(part)]) + body + bytes(len(body) % 2)
            i = k
        out += b"\x00\x00"
    return bytes(out) + b"\x00\x01"


def _rng(*key):
    return np.random.default_rng(list(key))


def _smooth(h, w, c, top, seed):
    """Gradients with blocks: runs for RLE, structure for the filters, every value class reached."""
    rng = _rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 3)[..., None] * (1 + np.arange(c)) + rng.integers(0, 3, (h, w, c))
    base[h // 3 : h // 2, w // 4 : w // 2] = rng.integers(0, top + 1, c)
    return base % (top + 1)


# --------------------------------------------------------------------------- #
# Format by content
# --------------------------------------------------------------------------- #
def test_sniff_reads_magic_bytes_only():
    assert image_decode.sniff(b"\xff\xd8\xff\xe0rest") == "jpeg"
    assert image_decode.sniff(png.SIGNATURE + b"rest") == "png"
    assert image_decode.sniff(b"BM\x00\x00") == "bmp"
    assert image_decode.sniff(b"RIFF\x10\x00\x00\x00WEBPVP8 ") == "webp"
    assert image_decode.sniff(b"GIF89a") is None and image_decode.sniff(b"") is None
    assert image_decode.sniff(b"\xff\xd8\x00") is None  # PIL's JPEG test wants a marker after SOI


def test_webp_and_unknown_formats_raise_naming_the_file():
    """WebP decodes as PIL decodes it (tests/test_torch_webp.py holds the format); anything else raises."""
    buf = io.BytesIO()
    Image.fromarray(_smooth(9, 7, 3, 255, 0).astype(np.uint8)).save(buf, "WEBP", lossless=True)
    assert _pil(buf.getvalue()).shape == (9, 7, 3)  # PIL decodes it in the JAX package
    np.testing.assert_array_equal(_decode(buf.getvalue(), "photo.webp"), _pil(buf.getvalue()))
    gif = io.BytesIO()
    Image.fromarray(_smooth(9, 7, 3, 255, 0).astype(np.uint8)).convert("P").save(gif, "GIF")
    for data in (gif.getvalue(), b"", b"plain text"):
        with pytest.raises(DecodeError, match="thing.png: not a JPEG, PNG, BMP or WebP"):
            image_decode.decode(data, "thing.png", "cpu")
    assert issubclass(native_decoder.JpegError, DecodeError) and issubclass(DecodeError, ValueError)


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #
PNG_MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
             (4, 16), (6, 8), (6, 16)]  # (colour type, bit depth): every pair PNG allows


def _png_case(colour, depth, seed, h=13, w=11):
    """(samples, write_png keyword arguments) for one colour type and depth."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    samples = _smooth(h, w, channels, (1 << depth) - 1, seed)
    kwargs = {}
    if colour == 3:  # a short palette: the highest indices fall past it (black in PIL), and a tRNS
        n = max(1, (1 << depth) - 1)
        kwargs["palette"] = _rng(seed, 1).integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        kwargs["trns"] = bytes(range(0, 256, 37))[:n]
    elif colour in (0, 2) and depth >= 8:
        kwargs["trns"] = struct.pack(f">{channels}H", *([1] * channels))
    return samples, kwargs


@pytest.mark.parametrize("interlace", [False, True], ids=["progressive-rows", "adam7"])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("colour, depth", PNG_MODES, ids=[f"c{c}d{d}" for c, d in PNG_MODES])
def test_png_every_colour_type_depth_and_filter_equals_pil(colour, depth, filter_type, interlace):
    samples, kwargs = _png_case(colour, depth, seed=colour * 100 + depth)
    data = write_png(samples, depth, colour, interlace=interlace, filters=(filter_type,), **kwargs)
    np.testing.assert_array_equal(_decode(data), _pil(data))


@pytest.mark.parametrize("colour, depth", [(2, 8), (0, 16), (3, 2), (6, 16)])
def test_png_filters_on_uniform_noise(colour, depth):
    """Noise reaches what gradients do not, such as Paeth's ties between left and up (a + b = 2c)."""
    channels = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    samples = _rng(colour, depth).integers(0, 1 << depth, (31, 29, channels))
    kwargs = {"palette": _rng(9).integers(0, 256, 12, dtype=np.uint8).tobytes()} if colour == 3 else {}
    for interlace in (False, True):
        data = write_png(samples, depth, colour, interlace=interlace, **kwargs)
        np.testing.assert_array_equal(_decode(data), _pil(data))


@pytest.mark.parametrize("h, w", [(1, 1), (2, 3), (5, 1), (9, 17), (16, 16), (33, 7)])
def test_png_adam7_at_sizes_with_empty_passes(h, w):
    """Passes of zero width or height hold no scanlines; mixed filters per row within each pass."""
    for colour, depth in ((2, 8), (0, 1), (3, 4), (6, 16)):
        samples, kwargs = _png_case(colour, depth, seed=h * w, h=h, w=w)
        data = write_png(samples, depth, colour, interlace=True, **kwargs)
        np.testing.assert_array_equal(_decode(data), _pil(data))


def test_png_sixteen_bit_gray_clips_at_255_as_pil_does():
    """PIL opens 16-bit gray as I;16 and clips it at 255 on the way to RGB; 16-bit colour keeps the high byte."""
    gray = np.array([[[0], [1], [255], [256], [4000], [65535]]])
    data = write_png(gray, 16, 0)
    assert Image.open(io.BytesIO(data)).mode == "I;16"
    np.testing.assert_array_equal(_decode(data)[0, :, 0], [0, 1, 255, 255, 255, 255])
    np.testing.assert_array_equal(_decode(data), _pil(data))
    rgb = np.array([[[4000, 256, 255]]])
    np.testing.assert_array_equal(_decode(write_png(rgb, 16, 2))[0, 0], [15, 1, 0])


def test_png_pil_written_modes_and_split_idat():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (21, 19, 3), dtype=np.uint8)
    for im in (Image.fromarray(arr), Image.fromarray(arr).convert("RGBA"), Image.fromarray(arr).convert("LA"),
               Image.fromarray(arr).convert("1"), Image.fromarray(arr).quantize(5),
               Image.fromarray(arr).convert("P", palette=Image.Palette.ADAPTIVE, colors=200)):
        buf = io.BytesIO()
        im.save(buf, "PNG", optimize=True)
        np.testing.assert_array_equal(_decode(buf.getvalue()), _pil(buf.getvalue()))
    samples, _ = _png_case(2, 8, 5, h=20, w=20)
    data = write_png(samples, 8, 2, idat_parts=4)
    np.testing.assert_array_equal(_decode(data), samples.astype(np.uint8))


def _png_with_chunk_after(data: bytes, after: bytes, chunk: bytes) -> bytes:
    at = data.index(after) - 4
    length = struct.unpack(">I", data[at : at + 4])[0]
    end = at + 12 + length
    return data[:end] + chunk + data[end:]


def test_png_corrupt_truncated_and_bad_crc_raise_where_pil_does():
    samples, kwargs = _png_case(2, 8, 9, h=24, w=20)
    good = write_png(samples, 8, 2)
    idat = good.index(b"IDAT")
    ihdr_crc = good.index(b"IHDR") + 4 + 13
    bad_text = png_chunk(b"tEXt", b"k\x00v")
    bad_text = bad_text[:-1] + bytes([bad_text[-1] ^ 1])
    cases = {
        "truncated.png": good[: len(good) // 2],
        "truncated_header.png": good[:20],
        "bad_ihdr_crc.png": good[:ihdr_crc] + bytes([good[ihdr_crc] ^ 0xFF]) + good[ihdr_crc + 1 :],
        "bad_ancillary_crc.png": _png_with_chunk_after(good, b"IHDR", bad_text),
        "broken_zlib.png": good[: idat + 10] + b"\xff" * 12 + good[idat + 22 :],
        "no_idat.png": png.SIGNATURE + good[8 : idat - 4] + png_chunk(b"IEND", b""),
        "signature_only.png": png.SIGNATURE,
        "bad_filter_method.png": png.SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 1, 0))
        + good[good.index(b"IDAT") - 4 :],
        "bad_depth.png": png.SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
        + good[good.index(b"IDAT") - 4 :],
    }
    raw = filter_rows(pack_samples(samples.reshape(24, -1), 8), 3, (0,))
    cases["bad_filter.png"] = write_png(samples, 8, 2)[: idat - 4] + png_chunk(
        b"IDAT", zlib.compress(bytes([7]) + raw[1:])) + png_chunk(b"IEND", b"")
    for name, data in cases.items():
        with pytest.raises(Exception):
            _pil(data)  # PIL refuses every one of these
        with pytest.raises(DecodeError, match=name):
            image_decode.decode(data, name, "cpu")


def test_png_crc_and_iend_are_checked_where_pil_checks_them():
    """PIL checks the CRC of each chunk before the first IDAT only, and needs no IEND: equal arrays."""
    samples, _ = _png_case(6, 8, 11, h=10, w=12)
    good = write_png(samples, 8, 6, idat_parts=2)
    last_idat = good.rindex(b"IDAT")
    length = struct.unpack(">I", good[last_idat - 4 : last_idat])[0]
    crc_at = last_idat + 4 + length
    bad_idat_crc = good[:crc_at] + bytes([good[crc_at] ^ 1]) + good[crc_at + 1 :]
    no_iend = good[: good.index(b"IEND") - 4]
    bad_text_after = png_chunk(b"tEXt", b"k\x00v")
    bad_text_after = good[: good.index(b"IEND") - 4] + bad_text_after[:-1] + b"\x00" + png_chunk(b"IEND", b"")
    for name, data in (("idat_crc", bad_idat_crc), ("no_iend", no_iend), ("late_crc", bad_text_after)):
        assert _assert_like_pil(data, name) == "decodes", name


def test_png_inflate_is_bounded_by_the_header():
    """A 1×1 image whose zlib stream would inflate to 64 MB: the port inflates the 4 bytes the header
    needs and decodes as PIL does."""
    z = zlib.compress(b"\x00\x05\x06\x07" + bytes(64 << 20), 9)
    data = (png.SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
            + png_chunk(b"IDAT", z) + png_chunk(b"IEND", b""))
    assert len(data) < 100_000
    header, idat = png.read_chunks(data, "bomb.png")
    assert header.filtered_size() == 4 and len(png.inflate(idat, 4, "bomb.png")) == 4
    np.testing.assert_array_equal(_decode(data), _pil(data))
    np.testing.assert_array_equal(_decode(data)[0, 0], [5, 6, 7])


@pytest.mark.parametrize("fmt", ["png", "bmp", "jpeg", "webp"])
def test_size_guard_refuses_what_pil_refuses_before_allocating(fmt):
    """PIL refuses more than 2 · MAX_IMAGE_PIXELS pixels when it opens a file; so does the port, from the
    header alone (no pixel data follows)."""
    w, h = 20000, 10000
    assert w * h > 2 * MAX_IMAGE_PIXELS > 13000 * 13000
    if fmt == "png":
        data = png.SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + png_chunk(
            b"IDAT", zlib.compress(b"")) + png_chunk(b"IEND", b"")
    elif fmt == "bmp":
        data = write_bmp(w, h, 24, b"")
    elif fmt == "webp":  # a VP8L header (14-bit sizes) and no pixel data
        w, h = 16383, 12000
        body = bytes([0x2F]) + ((w - 1) | (h - 1) << 14).to_bytes(4, "little") + bytes(7)
        data = b"RIFF" + struct.pack("<I", 12 + len(body)) + b"WEBPVP8L" + struct.pack("<I", len(body)) + body
    else:
        good = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(good, "JPEG")
        raw = good.getvalue()
        sof = raw.index(b"\xff\xc0")
        data = raw[: sof + 5] + struct.pack(">HH", h, w) + raw[sof + 9 :]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(DecodeError, match=f"big.{fmt}: .*decompression bomb"):
        image_decode.decode(data, f"big.{fmt}", "cpu")


# --------------------------------------------------------------------------- #
# BMP
# --------------------------------------------------------------------------- #
def _palette(n, seed, entry=4):
    colours = _rng(seed, 7).integers(0, 256, (n, 3), dtype=np.uint8)
    pad = np.zeros((n, entry - 3), np.uint8)
    return np.hstack([colours, pad]).tobytes()


def _bmp_case(case):
    """(BMP bytes) for one variant: 24×13 or its own size, values from a seeded generator."""
    w, h = 23, 13
    if case in ("pal1", "pal4", "pal8", "pal8_short", "gray8", "mono1", "core8", "topdown8", "pal4_short"):
        bits = {"pal1": 1, "mono1": 1, "pal4": 4, "pal4_short": 4}.get(case, 8)
        n = 1 << bits
        colors = {"pal8_short": 10, "pal4_short": 5}.get(case, 0)
        idx = _smooth(h, w, 1, (n - 1) if not colors else min(n - 1, colors + 3), sum(case.encode()))[..., 0]
        entry = 3 if case == "core8" else 4
        if case == "gray8":
            table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
            table[:, 3] = 0
            table = table.tobytes()
        elif case == "mono1":
            table = bytes([0, 0, 0, 0, 255, 255, 255, 0])
        else:
            table = _palette(colors or n, len(case), entry)
        rows = pack_samples(idx, bits)
        return write_bmp(w, h, bits, bmp_rows(rows, case == "topdown8"), table=table, colors=colors,
                         header=12 if case == "core8" else 40, top_down=case == "topdown8")
    if case in ("rgb24", "topdown24", "core24", "v4_24"):
        px = _smooth(h, w, 3, 255, 24).astype(np.uint8)
        return write_bmp(w, h, 24, bmp_rows(px.reshape(h, -1), case == "topdown24"), top_down=case == "topdown24",
                         header={"core24": 12, "v4_24": 108}.get(case, 40))
    if case in ("rgb555", "bf565", "bf555"):
        v = _smooth(h, w, 1, 65535, 16)[..., 0].astype("<u2")
        masks = {"bf565": (0xF800, 0x7E0, 0x1F), "bf555": (0x7C00, 0x3E0, 0x1F)}.get(case, ())
        return write_bmp(w, h, 16, bmp_rows(v.view(np.uint8).reshape(h, -1)), compression=3 if masks else 0,
                         masks=masks)
    if case == "bgrx32":
        px = _smooth(h, w, 4, 255, 32).astype(np.uint8)
        return write_bmp(w, h, 32, bmp_rows(px.reshape(h, -1)))
    if case.startswith("rle"):
        rle4 = case.startswith("rle4")
        idx = _smooth(h, w, 1, 15 if rle4 else 255, 8)[..., 0]
        idx[2, :] = 3  # a long run
        n = 16 if rle4 else 256
        return write_bmp(w, h, 4 if rle4 else 8, rle_encode(idx, rle4), compression=2 if rle4 else 1,
                         table=_palette(n, 5))
    raise KeyError(case)


BMP_CASES = ["pal1", "mono1", "pal4", "pal4_short", "pal8", "pal8_short", "gray8", "core8", "core24", "topdown8",
             "rgb24", "topdown24", "v4_24", "rgb555", "bf565", "bf555", "bgrx32", "rle8", "rle4"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_variants_equal_pil(case):
    data = _bmp_case(case)
    want = _pil(data)
    assert want.shape == (13, 23, 3)
    np.testing.assert_array_equal(_decode(data, f"{case}.bmp"), want)


MASKS_32 = [((0xFF0000, 0xFF00, 0xFF, 0x0), 40), ((0xFF000000, 0xFF0000, 0xFF00, 0x0), 56),
            ((0xFF000000, 0xFF00, 0xFF, 0x0), 56), ((0xFF000000, 0xFF0000, 0xFF00, 0xFF), 108),
            ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), 124), ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
            ((0xFF000000, 0xFF00, 0xFF, 0xFF0000), 56), ((0, 0, 0, 0), 108)]


@pytest.mark.parametrize("masks, header", MASKS_32, ids=[f"{m[0]:x}-{m[3]:x}-h{h}" for m, h in MASKS_32])
def test_bmp_32_bit_bitfields_equal_pil(masks, header):
    w, h = 9, 7
    px = _smooth(h, w, 4, 255, sum(masks) % 97).astype(np.uint8)
    data = write_bmp(w, h, 32, bmp_rows(px.reshape(h, -1)), compression=3, masks=masks, header=header)
    np.testing.assert_array_equal(_decode(data), _pil(data))


def test_bmp_24_bit_bitfields_and_v5_top_down():
    w, h = 10, 6
    px = _smooth(h, w, 3, 255, 4).astype(np.uint8)
    for header, top in ((40, False), (124, True), (52, False)):
        data = write_bmp(w, h, 24, bmp_rows(px.reshape(h, -1), top), compression=3, masks=(0xFF0000, 0xFF00, 0xFF),
                         header=header, top_down=top)
        np.testing.assert_array_equal(_decode(data), _pil(data))


def test_bmp_rle_escapes_absolute_odd_lengths_and_delta_follow_pil():
    """End of line early, end of bitmap, odd absolute stretches (RLE4: PIL reads count // 2 bytes), and
    a delta (Pillow 12 takes its offsets from two bytes further on): equal to PIL where it decodes."""
    table = _palette(256, 2)
    w, h = 8, 3
    streams = {  # PIL counts columns from the last end of line, so every row ends in one
        "eol_early": b"\x03\x05\x00\x00" + b"\x08\x06\x00\x00" + b"\x08\x07\x00\x00" + b"\x00\x01",
        "absolute_odd8": b"\x00\x03\x01\x02\x03\x00" + b"\x05\x09\x00\x00" + b"\x08\x04\x00\x00" * 2 + b"\x00\x01",
        "delta": b"\x02\x01\x00\x02\x01\x01\x01\x00" + b"\x08\x03\x00\x00" * 3 + b"\x00\x01",
        "overlong_run": b"\xff\x02\x00\x00" + b"\x08\x03\x00\x00" * 2,
        "no_eol": b"\x08\x05\x08\x06\x08\x07\x00\x01",
        "short": b"\x04\x01\x00\x01",
    }
    outcomes = {}
    for name, stream in streams.items():
        outcomes[name] = _assert_like_pil(write_bmp(w, h, 8, stream, compression=1, table=table), f"{name}.bmp")
    rle4 = {"absolute_odd4": b"\x00\x03\x12\x30" + b"\x05\x45\x00\x00" + b"\x08\x67\x00\x00" * 2 + b"\x00\x01",
            "run4": b"\x07\xab\x00\x00" + b"\x08\xcd\x00\x00" * 2 + b"\x00\x01"}
    for name, stream in rle4.items():
        outcomes[name] = _assert_like_pil(write_bmp(w, h, 4, stream, compression=2, table=_palette(16, 3)),
                                          f"{name}.bmp")
    decodes = {"eol_early", "absolute_odd8", "overlong_run", "run4", "absolute_odd4"}
    assert {k for k, v in outcomes.items() if v == "decodes"} >= decodes, outcomes
    assert outcomes["short"] == outcomes["no_eol"] == "raises", outcomes


def test_bmp_corrupt_and_unsupported_raise_where_pil_does():
    good = _bmp_case("rgb24")
    px = _smooth(4, 4, 4, 255, 1).astype(np.uint8)
    cases = {
        "truncated.bmp": good[: len(good) - 40],
        "header_only.bmp": good[:30],
        "bad_header_size.bmp": good[:14] + struct.pack("<I", 20) + good[18:],
        "jpeg_compression.bmp": write_bmp(4, 4, 24, bmp_rows(px[..., :3].reshape(4, -1)), compression=4),
        "unknown_masks.bmp": write_bmp(4, 4, 32, bmp_rows(px.reshape(4, -1)), compression=3,
                                       masks=(0xF00, 0xF0, 0xF, 0)),
        "depth_2.bmp": write_bmp(4, 4, 2, bytes(16), table=_palette(4, 1)),
        "rle_rgb.bmp": write_bmp(4, 4, 24, b"\x04\x01" * 4, compression=1),
    }
    for name, data in cases.items():
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(DecodeError, match=name):
            image_decode.decode(data, name, "cpu")


def test_bmp_quirks_follow_pil():
    """A gray-ramp palette of 2 colours over 8-bit data (PIL reads the rows as 1-bit), indices past a short
    palette, and a data offset that forgot the colour table."""
    w, h = 16, 4
    idx = _smooth(h, w, 1, 255, 3)[..., 0].astype(np.uint8)
    ramp2 = write_bmp(w, h, 8, bmp_rows(idx), table=bytes([0, 0, 0, 0, 255, 255, 255, 0]), colors=2)
    short = write_bmp(w, h, 8, bmp_rows(idx % 16), table=_palette(6, 4), colors=6)
    table = _palette(256, 6)
    forgot = write_bmp(w, h, 8, bmp_rows(idx), table=table, offset=14 + 40)
    for name, data in (("ramp2", ramp2), ("short", short), ("forgot", forgot)):
        assert _assert_like_pil(data, name) == "decodes", name


# --------------------------------------------------------------------------- #
# JPEG: CMYK, YCCK and RGB-coded
# --------------------------------------------------------------------------- #
def _cmyk_jpeg(subsampling, seed=0, size=(37, 29)):
    rgb = _smooth(size[1], size[0], 3, 255, seed).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", quality=88, subsampling=subsampling)
    return buf.getvalue()


def test_cmyk_conversion_equals_pil_for_every_value():
    """planes_to_rgb's CMYK end (PIL's CMYK;I unpacking, then cmyk2rgb) on every (stored C, K) pair, and
    M and Y drawn at random, against PIL converting the inverted CMYK it would have unpacked."""
    stored_c, stored_k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.default_rng(0)
    planes = [stored_c, rng.integers(0, 256, (256, 256)), rng.integers(0, 256, (256, 256)), stored_k]
    planes = [torch.from_numpy(p.astype(np.uint8)) for p in planes]
    inverted = 255 - np.stack([p.numpy() for p in planes], -1)
    want = np.asarray(Image.fromarray(inverted, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(native_decoder.planes_to_rgb(planes, "cmyk").numpy(), want)


@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_cmyk_jpeg_equals_pil_through_the_libjpeg_shim(subsampling):
    data = _cmyk_jpeg(subsampling)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"
    header = native_decoder.read_header(data)
    assert (header.colour, header.width, header.height) == ("cmyk", 37, 29)
    np.testing.assert_array_equal(_decode(data), _pil(data))


@pytest.mark.parametrize("name", ["cmyk_444_240x180.jpg", "cmyk_420_241x179.jpg", "ycck_444_240x180.jpg",
                                  "ycck_420_241x179.jpg", "rgb_coded_240x180.jpg"])
def test_fixture_four_plane_and_rgb_coded_jpegs_equal_pil(name):
    """libjpeg's reading of the markers (Adobe transform 0 / 2, RGB ids) equals read_header's, which the
    card decides by; the decode equals PIL's exactly."""
    data = (FIXTURES / name).read_bytes()
    assert native_decoder.read_header(data).colour == name.split("_")[0]
    np.testing.assert_array_equal(_decode(data, name), _pil(data))
    np.testing.assert_array_equal(_decode(data, name), np.load(FIXTURES / "pil_full.npz")[name])


def test_jpeg_layouts_pil_does_not_read_raise():
    good = io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(good, "JPEG")
    raw = good.getvalue()
    sof = raw.index(b"\xff\xc0")
    twelve_bit = raw[: sof + 4] + b"\x0c" + raw[sof + 5 :]
    for data in (twelve_bit,):
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(DecodeError, match="odd.jpg"):
            image_decode.decode(data, "odd.jpg", "cpu")


# --------------------------------------------------------------------------- #
# Fixtures, folders
# --------------------------------------------------------------------------- #
def test_fixtures_equal_pil_arrays_and_stay_small():
    """PNG, BMP and JPEG fixtures against pil_full.npz; WebP fixtures against the SHA-256 of PIL's arrays
    (pil_webp_sha256.json, written with them by webp_fixtures.py). Each group stays under 1 MiB."""
    ref = np.load(FIXTURES / "pil_full.npz")
    webp_refs = json.loads((FIXTURES / "pil_webp_sha256.json").read_text())
    images = sorted(p.name for p in FIXTURES.iterdir() if image_decode.sniff(p.read_bytes()[:16]) is not None)
    files = [f for f in images if not f.endswith(".webp")]
    assert sorted(ref.files) == files and len(files) >= 16
    assert sorted(webp_refs) == [f for f in images if f.endswith(".webp")] and len(webp_refs) >= 19
    webp_group = [FIXTURES / f for f in webp_refs] + [FIXTURES / "pil_webp_sha256.json",
                                                     FIXTURES / "webp_recipes.cpp", FIXTURES / "webp_fixtures.py"]
    assert sum(p.stat().st_size for p in webp_group) < 2**20
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p not in webp_group) < 2**20
    kinds = {image_decode.sniff((FIXTURES / f).read_bytes()) for f in images}
    assert kinds == {"jpeg", "png", "bmp", "webp"}
    for name in files:
        data = (FIXTURES / name).read_bytes()
        np.testing.assert_array_equal(_pil(data), ref[name])
        np.testing.assert_array_equal(_decode(data, name), ref[name])
    for name, want in webp_refs.items():
        data = (FIXTURES / name).read_bytes()
        for got in (_pil(data), _decode(data, name)):
            got = np.ascontiguousarray(got)
            assert list(got.shape) == want["shape"], name
            assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Two classes of every format: PIL JPEGs, CMYK JPEGs, PNGs (one under a .JPEG name), BMPs, fixtures."""
    root = tmp_path_factory.mktemp("mixed")
    for cls in ("ants", "bees"):
        (root / cls).mkdir()
    rgb = _smooth(61, 83, 3, 255, 1).astype(np.uint8)
    Image.fromarray(rgb).save(root / "ants" / "a.jpg", quality=90)
    (root / "ants" / "b_cmyk.jpg").write_bytes(_cmyk_jpeg(2, seed=2, size=(70, 50)))
    samples, kwargs = _png_case(3, 4, 7, h=40, w=64)
    (root / "ants" / "c.png").write_bytes(write_png(samples, 4, 3, interlace=True, **kwargs))
    samples, _ = _png_case(2, 16, 8, h=57, w=49)
    (root / "bees" / "n02105855_2933.JPEG").write_bytes(write_png(samples, 16, 2))
    (root / "bees" / "d.bmp").write_bytes(_bmp_case("rle8"))
    (root / "bees" / "e.bmp").write_bytes(_bmp_case("bf565"))
    for name in ("ycck_420_241x179.jpg", "png_gray16_adam7_90x70.png", "bmp_pal4_rle_75x50.bmp"):
        (root / "bees" / name).write_bytes((FIXTURES / name).read_bytes())
    return root


def test_mixed_folder_batches_within_one_level_of_jax_pil(mixed):
    """get_batch and iter_batches over every format, the PNG under a .JPEG name included, against the JAX
    ImageFolder(decoder="pil")."""
    t = ImageFolder(mixed, image_size=SIZE, device="cpu")
    j = JFolder(mixed, image_size=SIZE, decoder="pil")
    assert t.samples == j.samples and len(t) == 9
    assert image_decode.sniff((mixed / "bees" / "n02105855_2933.JPEG").read_bytes()) == "png"
    want = j.get_batch(0, len(j)).astype(int)
    got = t.get_batch(0, len(t))
    assert isinstance(got, torch.Tensor) and got.shape == (len(t), SIZE, SIZE, 3)
    for i, (path, _) in enumerate(t.samples):
        assert np.abs(got[i].numpy().astype(int) - want[i]).max() <= 1, path.name
    batches = list(iter_batches(t, 4))
    assert [b.start_index for b in batches] == [0, 4, 8]
    np.testing.assert_array_equal(torch.cat([b.images for b in batches])[: len(t)].numpy(), got.numpy())


def test_broken_file_in_a_folder_names_it(mixed, tmp_path):
    (tmp_path / "a.png").write_bytes((mixed / "ants" / "c.png").read_bytes()[:100])
    (tmp_path / "b.bmp").write_bytes(b"BM" + bytes(30))
    (tmp_path / "c.webp").write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8L")
    ds = ImageFolder(tmp_path, image_size=SIZE, device="cpu")
    for i, stem in enumerate(("a.png", "b.bmp", "c.webp")):
        with pytest.raises(DecodeError, match=stem):
            ds[i]
    with pytest.raises(DecodeError, match="a.png"):
        ds.get_batch(0, 3)


def test_bmp_and_png_modules_take_the_device_they_are_given():
    """The parsers hand one uint8 tensor to the device; the conversion runs there (here: the CPU)."""
    samples, kwargs = _png_case(3, 2, 1)
    header, idat = png.read_chunks(write_png(samples, 2, 3, **kwargs), "x")
    rows = png.unfilter(png.inflate(idat, header.filtered_size(), "x"), header, "x")
    assert rows.shape == (header.height, header.stride) and rows.dtype == np.uint8
    out = png.to_rgb(torch.from_numpy(rows), header)
    assert out.shape == (13, 11, 3) and out.dtype == torch.uint8
    assert bmp.decode(_bmp_case("pal4"), "x", torch.device("cpu")).device.type == "cpu"
