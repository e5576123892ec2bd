"""BMP decoding for the port, to the RGB array PIL gives.

The contract is the JAX package's ``np.asarray(Image.open(f).convert("RGB"))``;
this follows Pillow's ``BmpImagePlugin`` (its ``_bitmap`` and
``BmpRleDecoder``) step by step, quirks included, and is checked against
Pillow in ``tests/test_torch_image_formats.py``. It reads the core (OS/2)
header and the INFO, V2–V5 headers; 1-, 4- and 8-bit palette images; 16-bit
(5-5-5, and 5-6-5 or 5-5-5 bit fields), 24-bit and 32-bit pixels (BGRX, and
the bit-field layouts PIL knows, alpha dropped); ``BI_RLE8`` and
``BI_RLE4``; rows bottom-up and top-down.

The header, the colour table and the run-length decoding are parsed on the
host; the packed rows then go to the target device in one upload, and the
unpacking to RGB runs there as torch ops.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from semanticlens_tpu_torch.data.raw import DecodeError, check_size, palette_table, unpack_samples

_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# bits per pixel → (PIL mode, PIL raw mode) without bit fields
_BIT_MODES = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
              32: ("RGB", "BGRX")}
# (bits, masks) → raw mode: PIL's SUPPORTED bit-field layouts (R, G, B and, at 32 bits, A masks)
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# raw mode → bits it reads per pixel
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}
# byte raw modes → byte offsets of R, G and B within a pixel
_BYTE_ORDER = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0), "ABGR": (3, 2, 1),
               "RGBA": (0, 1, 2), "BGRA": (2, 1, 0), "BGAR": (3, 1, 0)}


def _u16(b: bytes, at: int) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool, name: str) -> bytearray:
    """Pillow's ``BmpRleDecoder`` on the stream at file offset ``pos``: one palette index per byte, rows
    in file order, until the image is full or the stream ends. Pillow 12 reads a delta's offsets from
    the two bytes after the two that follow the escape, and so does this."""
    out, x, total = bytearray(), 0, width * height
    while len(out) < total:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run, cut at the row's end
            count = min(count, max(0, width - x))
            if rle4:
                out += bytes((byte >> 4, byte & 0x0F)) * (count // 2) + bytes((byte >> 4,)) * (count % 2)
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if pos + 2 > len(data):
                break
            if pos + 4 > len(data):
                raise DecodeError(f"{name}: truncated BMP run-length delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute: `byte` indices (PIL reads byte // 2 bytes for RLE4), then to an even file offset
            n = byte // 2 if rle4 else byte
            chunk = data[pos : pos + n]
            pos += len(chunk)
            out += bytes(v for b in chunk for v in (b >> 4, b & 0x0F)) if rle4 else chunk
            if len(chunk) < n:
                break
            x += byte
            pos += pos % 2
    return out


def decode(data: bytes, name: str, device) -> torch.Tensor:
    """BMP bytes → (H, W, 3) uint8 RGB on ``device`` at full resolution, equal to PIL's."""
    if not data.startswith(b"BM"):
        raise DecodeError(f"{name}: not a BMP file")
    if len(data) < 18:
        raise DecodeError(f"{name}: truncated BMP file")
    offset, header_size = _u32(data, 10), _u32(data, 14)
    if header_size not in _HEADER_SIZES:
        raise DecodeError(f"{name}: unsupported BMP header type ({header_size})")
    info, pos = data[18 : 14 + header_size], 14 + header_size
    if len(info) < header_size - 4:
        raise DecodeError(f"{name}: truncated BMP header")
    if header_size == 12:  # BITMAPCOREHEADER
        width, height, bits = _u16(info, 0), _u16(info, 2), _u16(info, 6)
        compression, colors, entry, top_down = _RAW, 0, 3, False
    else:
        top_down = info[7] == 0xFF
        width, height = _u32(info, 0), _u32(info, 4)
        height = 2**32 - height if top_down else height
        bits, compression, colors, entry = _u16(info, 10), _u32(info, 12), _u32(info, 28), 4
        if compression == _BITFIELDS:
            if len(info) >= 48:
                masks = [_u32(info, 36 + 4 * i) for i in range(4 if len(info) >= 52 else 3)]
            else:  # an INFO header: the three masks follow it
                if pos + 12 > len(data):
                    raise DecodeError(f"{name}: truncated BMP bit-field masks")
                masks, pos = [_u32(data, pos + 4 * i) for i in range(3)], pos + 12
            masks += [0] * (4 - len(masks))
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors  # PIL's skip of a colour table the data offset forgot
    if bits not in _BIT_MODES:
        raise DecodeError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, rawmode = _BIT_MODES[bits]
    if compression == _BITFIELDS:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise DecodeError(f"{name}: unsupported BMP bit-field layout {[hex(m) for m in masks]}")
        rawmode = _MASK_MODES[key]
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise DecodeError(f"{name}: unsupported BMP compression ({compression})")
    table = b""
    if mode == "P":
        if not 0 < colors <= 65536:
            raise DecodeError(f"{name}: unsupported BMP palette size ({colors})")
        table = data[pos : pos + entry * colors]
        pos += len(table)
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(table[i * entry : i * entry + 3] == bytes((v & 255,)) * 3 for i, v in enumerate(ramp)):
            mode = rawmode = "1" if colors == 2 else "L"  # a gray ramp: PIL drops the palette
    check_size(width, height, name)
    if width == 0 or height == 0:
        raise DecodeError(f"{name}: BMP image of size {width}x{height}")
    start = offset or pos
    if compression in (_RLE8, _RLE4):
        if mode not in ("P", "L"):  # PIL has no unpacker from palette indices to its "1" or "RGB" mode
            raise DecodeError(f"{name}: run-length data for a {bits}-bit {mode} BMP")
        indices = _rle(data, start, width, height, compression == _RLE4, name)
        if len(indices) < width * height:
            raise DecodeError(f"{name}: not enough BMP image data")
        rawmode, stride = ("L" if mode == "L" else "P"), width
        rows = np.frombuffer(bytes(indices[: width * height]), dtype=np.uint8).reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        line = -(-width * _RAW_BITS.get(rawmode, 32) // 8)
        if line > stride:
            raise DecodeError(f"{name}: BMP rows of {stride} bytes hold no {rawmode} row of {line}")
        needed = (height - 1) * stride + line
        pixels = data[start : start + needed]
        if len(pixels) < needed:
            raise DecodeError(f"{name}: truncated BMP image data ({len(pixels)} of {needed} bytes)")
        rows = np.frombuffer(pixels.ljust(height * stride, b"\0"), dtype=np.uint8).reshape(height, stride)
    rgb = _to_rgb(torch.from_numpy(rows.copy()).to(device), width, rawmode, table, entry)
    return rgb if top_down else rgb.flip(0)


def _to_rgb(rows: torch.Tensor, width: int, rawmode: str, table: bytes, entry: int) -> torch.Tensor:
    """(H, stride) uint8 rows in file order → (H, W, 3) uint8, PIL's unpacker for ``rawmode`` and then
    its RGB conversion."""
    if rawmode in ("1", "L", "P;1", "P;4", "P"):
        values = unpack_samples(rows, width, _RAW_BITS[rawmode])
        if rawmode in ("1", "L"):
            return (values * (255 if rawmode == "1" else 1)).to(torch.uint8)[..., None].expand(-1, -1, 3)
        return palette_table(table, entry, (2, 1, 0), rows.device)[values.long()]
    if rawmode in ("BGR;15", "BGR;16"):
        pairs = rows[:, : 2 * width].to(torch.int32).view(rows.shape[0], width, 2)
        v = pairs[..., 0] | pairs[..., 1] << 8  # little-endian 16-bit pixels
        fields = ((10, 31), (5, 31), (0, 31)) if rawmode == "BGR;15" else ((11, 31), (5, 63), (0, 31))
        return torch.stack([(v >> s & m) * 255 // m for s, m in fields], -1).to(torch.uint8)
    order = _BYTE_ORDER[rawmode]
    size = 3 if rawmode == "BGR" else 4
    return rows[:, : width * size].view(rows.shape[0], width, size)[..., list(order)]
