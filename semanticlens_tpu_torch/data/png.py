"""PNG decoding for the port, to the RGB array PIL gives.

The contract is the JAX package's ``np.asarray(Image.open(f).convert("RGB"))``
(``semanticlens_tpu/data/image_folder.py`` ``_pil_decode``), read from
Pillow's ``PngImagePlugin`` and checked against Pillow in
``tests/test_torch_image_formats.py``. Three steps:

1. the chunk walk and the inflate, in Python on the host (:func:`read_chunks`,
   :func:`inflate`): the signature, ``IHDR``, ``PLTE`` and the consecutive
   ``IDAT`` chunks joined, then ``zlib`` with the output bounded by what the
   header's size needs;
2. the unfiltering (filter types 0–4 per scanline) and Adam7, in
   ``csrc/png_cpu.cpp`` on the host: each byte depends on its left and upper
   neighbours after they were unfiltered, so the work is sequential along a
   row and from row to row, which suits no accelerator;
3. the conversion to RGB (:func:`to_rgb`), as torch ops on the target device
   after one upload of the unfiltered rows.

PIL's choices, copied here: the CRC of every chunk before the first ``IDAT``
is checked (and the ``IDAT`` chunks' and later ones' are not); a missing
``IEND`` is no error; 16-bit gray is PIL's ``I;16``, whose RGB conversion
clips at 255; other 16-bit samples keep their high byte; palette indices past
``PLTE`` are black; ``tRNS`` and alpha are dropped, nothing is composited.
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from semanticlens_tpu_torch.data import native_decoder
from semanticlens_tpu_torch.data.raw import DecodeError, check_size, palette_table, unpack_samples

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHUNK_TYPE = re.compile(rb"\w\w\w\w")  # PIL's is_cid
# colour type → (samples per pixel, allowed bit depths): PIL's _MODES
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
                 6: (4, (8, 16))}
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}  # PIL's "1", "L;2", "L;4" and "L" unpackers
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@dataclass(frozen=True)
class Header:
    width: int
    height: int
    depth: int  # bits per sample
    colour: int  # PNG colour type: 0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA
    interlace: bool
    palette: bytes  # PLTE's RGB triples, empty without one

    @property
    def samples(self) -> int:
        return _COLOUR_TYPES[self.colour][0]

    @property
    def bits_per_pixel(self) -> int:
        return self.samples * self.depth

    @property
    def stride(self) -> int:
        return -(-self.width * self.bits_per_pixel // 8)

    def filtered_size(self) -> int:
        """Bytes of the inflated stream: each scanline of each pass, plus its filter-type byte."""
        passes = _ADAM7 if self.interlace else ((0, 0, 1, 1),)
        total = 0
        for x0, y0, dx, dy in passes:
            pw, ph = -(-(self.width - x0) // dx), -(-(self.height - y0) // dy)
            if pw > 0 and ph > 0:
                total += ph * (1 + -(-pw * self.bits_per_pixel // 8))
        return total


def _lib() -> ctypes.CDLL:
    return native_decoder.library("png_cpu", {
        "sl_png_unfilter": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int],
    })


def read_chunks(data: bytes, name: str) -> tuple[Header, bytes]:
    """The header and the joined ``IDAT`` payload of a PNG file, walked as PIL walks it."""
    if not data.startswith(SIGNATURE):
        raise DecodeError(f"{name}: not a PNG file (no PNG signature)")
    fields, palette, pos = None, b"", len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise DecodeError(f"{name}: truncated PNG file (no image data)")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        if not _CHUNK_TYPE.fullmatch(ctype):
            raise DecodeError(f"{name}: broken PNG file (chunk {ctype!r})")
        if ctype == b"IDAT":
            break
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise DecodeError(f"{name}: truncated PNG file (chunk {ctype.decode()})")
        if zlib.crc32(ctype + body) != int.from_bytes(crc, "big"):
            raise DecodeError(f"{name}: broken PNG file (bad checksum in chunk {ctype.decode()})")
        if ctype == b"IEND":
            raise DecodeError(f"{name}: PNG file without image data")
        if ctype == b"IHDR":
            if length < 13:
                raise DecodeError(f"{name}: truncated IHDR chunk")
            fields = struct.unpack(">IIBBBBB", body[:13])
            if fields[5]:
                raise DecodeError(f"{name}: unknown PNG filter method {fields[5]}")
        elif ctype == b"PLTE" and fields is not None and fields[3] == 3:
            palette = body
        pos += 12 + length
    if fields is None:
        raise DecodeError(f"{name}: PNG image data before its IHDR chunk")
    width, height, depth, colour, _, _, interlace = fields
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise DecodeError(f"{name}: unsupported PNG bit depth {depth} with colour type {colour}")
    if width == 0 or height == 0:
        raise DecodeError(f"{name}: PNG image of size {width}x{height}")
    parts = []
    while pos + 8 <= len(data):  # consecutive IDAT chunks, empty ones allowed; their CRCs are not read
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        if ctype != b"IDAT":
            break
        parts.append(data[pos + 8 : pos + 8 + length])
        pos += 12 + length
    return Header(width, height, depth, colour, bool(interlace), palette), b"".join(parts)


def inflate(idat: bytes, size: int, name: str) -> bytes:
    """The first ``size`` bytes of the zlib stream ``idat``; never more, so a small file cannot
    inflate past what its header declares."""
    try:
        raw = zlib.decompressobj().decompress(idat, size)
    except zlib.error as exc:
        raise DecodeError(f"{name}: broken PNG image data ({exc})") from None
    if len(raw) < size:
        raise DecodeError(f"{name}: truncated PNG image data ({len(raw)} of {size} bytes)")
    return raw


def unfilter(raw: bytes, header: Header, name: str) -> np.ndarray:
    """Inflated scanlines → (height, stride) uint8 unfiltered rows in image order (``csrc/png_cpu.cpp``)."""
    out = np.empty((header.height, header.stride), dtype=np.uint8)
    status = _lib().sl_png_unfilter(raw, len(raw), out.ctypes.data, header.width, header.height,
                                    header.bits_per_pixel, int(header.interlace))
    if status == 1:
        raise DecodeError(f"{name}: unrecognized PNG filter type")
    if status != 0:
        raise DecodeError(f"{name}: truncated PNG image data")
    return out


def to_rgb(rows: torch.Tensor, header: Header) -> torch.Tensor:
    """(height, stride) uint8 unfiltered rows on any device → (height, width, 3) uint8 RGB there, as
    PIL's ``convert("RGB")`` of the mode it opens the file in."""
    w, depth, colour = header.width, header.depth, header.colour
    samples = unpack_samples(rows, w * header.samples, depth).view(header.height, w, header.samples)
    if colour == 3:
        return palette_table(header.palette, 3, (0, 1, 2), rows.device)[samples[..., 0].long()]
    if depth == 16:
        # 16-bit gray opens as I;16, which converts to RGB clipped at 255; other 16-bit samples keep
        # their high byte.
        samples = samples.clamp(max=255) if colour == 0 else samples >> 8
    elif colour == 0:
        samples = samples * _GRAY_SCALE[depth]
    rgb = samples[..., :3] if colour in (2, 6) else samples[..., :1].expand(-1, -1, 3)
    return rgb.to(torch.uint8)


def decode(data: bytes, name: str, device) -> torch.Tensor:
    """PNG bytes → (H, W, 3) uint8 RGB on ``device`` at full resolution, equal to PIL's."""
    header, idat = read_chunks(data, name)
    check_size(header.width, header.height, name)
    rows = unfilter(inflate(idat, header.filtered_size(), name), header, name)
    return to_rgb(torch.from_numpy(rows).to(device), header)
