"""WebP decoding for the port, to the RGB array PIL gives.

The contract is the JAX package's ``np.asarray(Image.open(f).convert("RGB"))``
(``semanticlens_tpu/data/image_folder.py`` ``_pil_decode``): Pillow opens
every WebP file through libwebp's animation decoder, which decodes the first
frame (a still image is a one-frame animation) into a zeroed RGBA canvas at
the frame's offset; ``convert("RGB")`` drops the alpha and keeps the RGB
under transparent pixels as stored. Three steps, as for PNG:

1. the RIFF container, in Python on the host (:func:`read_header`): the
   demuxer's rules copied from libwebp, so that a file is refused here
   exactly when PIL refuses it — the RIFF size against the bytes given (a
   truncated file is refused, bytes past the RIFF end are ignored), chunks
   padded to even sizes, a simple ``VP8 ``/``VP8L`` file or ``VP8X`` with its
   flags, canvas, ``ICCP``/``EXIF``/``XMP `` and unknown chunks skipped,
   ``ALPH`` before ``VP8 `` (used only where the ``VP8X`` alpha flag is set),
   ``ANIM`` and ``ANMF`` frames whose bitstream headers are all checked and
   whose first frame is decoded;
2. the bitstreams, in C++ on the host: ``csrc/webp_lossless.cpp`` (VP8L to
   ARGB words; ``ALPH``) and ``csrc/webp_lossy.cpp`` (a VP8 key frame to
   Y, U and V planes), with nothing outside the standard library; ``ALPH``
   is decoded and checked because libwebp fails a frame whose alpha fails,
   then dropped;
3. the conversion to RGB, as torch ops on the target device after one
   upload of the planes or words: for lossy frames libwebp's "fancy" 4:2:0
   upsampling and its fixed-point YUV → RGB in int32 (:func:`to_rgb`), for
   lossless ones a byte reorder.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from semanticlens_tpu_torch.data import native_decoder
from semanticlens_tpu_torch.data.raw import DecodeError, check_size

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ANIMATION, _XMP, _EXIF, _ALPHA, _ICCP = 0x02, 0x04, 0x08, 0x10, 0x20
_VALID_FLAGS = _ANIMATION | _XMP | _EXIF | _ALPHA | _ICCP
_IMAGE_CHUNKS = (b"VP8 ", b"VP8L")


class _Refused(Exception):
    """The demuxer refuses the file (libwebp's PARSE_ERROR, or PARSE_NEED_MORE_DATA on a whole file)."""


@dataclass
class Frame:
    """One frame as the demuxer stores it: chunk offsets and sizes (header and padded payload)."""

    number: int = 0
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    image: tuple[int, int] = (0, 0)  # (offset of the VP8/VP8L chunk, its size)
    alpha: tuple[int, int] = (0, 0)  # (offset of the ALPH chunk, its size)
    complete: bool = False


@dataclass
class Header:
    """A WebP file's canvas and its first frame, after the whole container was checked."""

    width: int  # canvas
    height: int
    frame: Frame
    data: bytes = field(repr=False)

    @property
    def lossless(self) -> bool:
        return self.data[self.frame.image[0] : self.frame.image[0] + 4] == b"VP8L"

    def bitstream(self) -> bytes:
        """The frame's VP8 or VP8L payload with its pad byte, as libwebp's decoder reads it."""
        offset, size = self.frame.image
        return self.data[offset + 8 : offset + size]

    def alpha(self) -> bytes | None:
        """The frame's ALPH payload, or None."""
        offset, size = self.frame.alpha
        if size == 0:
            return None
        length = int.from_bytes(self.data[offset + 4 : offset + 8], "little")
        return self.data[offset + 8 : offset + 8 + length]


def _bitstream_size(tag: bytes, body: bytes, size: int) -> tuple[int, int] | None:
    """(width, height) from the header of a ``VP8 `` or ``VP8L`` bitstream (``body``, its chunk's payload
    ``size`` bytes long) as libwebp's VP8GetInfo and VP8LGetInfo read it, or None where they fail."""
    if tag == b"VP8 ":
        if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
            return None
        bits = int.from_bytes(body[:3], "little")
        width, height = struct.unpack("<HH", body[6:10])
        width, height = width & 0x3FFF, height & 0x3FFF
        key_frame, profile, show, first_size = not bits & 1, (bits >> 1) & 7, (bits >> 4) & 1, bits >> 5
        if not key_frame or profile > 3 or not show or first_size >= size or not width or not height:
            return None
        return width, height
    if len(body) < 5 or body[0] != 0x2F or body[4] >> 5:
        return None
    bits = int.from_bytes(body[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _check_features(data: bytes) -> None:
    """libwebp's WebPGetFeatures on the whole file, which WebPAnimDecoderNew runs before the demuxer:
    a RIFF size of at least 12, a VP8X chunk of exactly 10 bytes, and for a still image the chunks up to
    the first bitstream within the RIFF size and that bitstream's header, of the canvas's size. Where it
    only lacks data after a VP8X chunk, libwebp reports the features and lets the demuxer judge."""
    riff_size = int.from_bytes(data[4:8], "little")
    if riff_size < 12 or riff_size > _MAX_CHUNK_PAYLOAD:
        raise _Refused(f"RIFF size {riff_size}")
    pos, canvas = 12, None
    if len(data) - pos < 8:
        raise _Refused("no chunk after the RIFF header")
    if data[pos : pos + 4] == b"VP8X":
        if int.from_bytes(data[pos + 4 : pos + 8], "little") != 10:
            raise _Refused("a VP8X chunk not 10 bytes long")
        if len(data) - pos < 18:
            raise _Refused("a truncated VP8X chunk")
        flags = data[pos + 8]
        canvas = (1 + int.from_bytes(data[pos + 12 : pos + 15], "little"),
                  1 + int.from_bytes(data[pos + 15 : pos + 18], "little"))
        if canvas[0] * canvas[1] >= _MAX_IMAGE_AREA:
            raise _Refused(f"canvas {canvas}")
        if flags & _ANIMATION:
            return
        pos += 18
        total = 22  # "WEBP", the VP8X chunk header and its payload
        while True:  # the optional chunks before the bitstream
            if len(data) - pos < 8:
                return
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            if size > _MAX_CHUNK_PAYLOAD:
                raise _Refused("chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff_size:
                raise _Refused("chunks past the RIFF size")
            if data[pos : pos + 4] in _IMAGE_CHUNKS:
                break
            if len(data) - pos < disk:
                return
            pos += disk
    elif len(data) - pos < 8:
        raise _Refused("no image chunk")
    tag, size = data[pos : pos + 4], int.from_bytes(data[pos + 4 : pos + 8], "little")
    if tag not in _IMAGE_CHUNKS:
        raise _Refused(f"first chunk {tag!r}")
    if size > riff_size - 12:
        raise _Refused("a bitstream chunk past the RIFF size")
    body = data[pos + 8 :]
    if len(body) < (5 if tag == b"VP8L" else 10):
        if canvas is None:
            raise _Refused("a truncated bitstream header")
        return
    image = _bitstream_size(tag, body, size)
    if image is None:
        raise _Refused(f"broken {tag.decode().strip()} header")
    if canvas is not None and image != canvas:
        raise _Refused(f"a {image[0]}x{image[1]} image on a {canvas[0]}x{canvas[1]} canvas")


class _Demuxer:
    """libwebp's demuxer (``src/demux/demux.c``) over a whole file, as WebPAnimDecoderNew runs it."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            raise _Refused("shorter than a RIFF header and a chunk header")
        riff_size = int.from_bytes(data[4:8], "little")
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused(f"truncated ({len(data)} of the {self.riff_end} bytes its RIFF header gives)")
        self.buf = data[: self.riff_end]
        self.start = 12
        self.flags = 0
        self.extended = False
        self.canvas = (0, 0)
        self.frames: list[Frame] = []

    # -- MemBuffer -------------------------------------------------------- #
    def left(self) -> int:
        return self.riff_end - self.start

    def _check_size(self, size: int):  # SizeIsInvalid, then the whole file's NEED_MORE_DATA
        if size > self.left():
            raise _Refused(f"a chunk of {size} bytes past the RIFF end")

    def take(self, n: int) -> int:
        value = int.from_bytes(self.buf[self.start : self.start + n], "little")
        self.start += n
        return value

    # -- parsers ---------------------------------------------------------- #
    def parse(self) -> None:
        tag = self.buf[12:16]
        if tag in _IMAGE_CHUNKS:
            self.parse_single_image()
            self.check_simple()
        elif tag == b"VP8X":
            self.parse_vp8x()
            self.check_extended()
        else:
            raise _Refused(f"first chunk {tag!r}")

    def store_frame(self, number: int, min_size: int, frame: Frame) -> None:
        """The ALPH and image chunks of one frame (StoreFrame)."""
        if self.left() < 8 or self.left() < min_size:
            raise _Refused("frame data missing")
        alpha_chunks = image_chunks = 0
        while True:
            chunk_start = self.start
            fourcc, payload = self.buf[self.start : self.start + 4], int.from_bytes(
                self.buf[self.start + 4 : self.start + 8], "little")
            self.start += 8
            if payload > _MAX_CHUNK_PAYLOAD:
                raise _Refused("chunk size")
            padded = payload + (payload & 1)
            self._check_size(padded)
            chunk_size = 8 + padded
            done = False
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha, frame.number = (chunk_start, chunk_size), number
                self.start += padded
            elif fourcc in _IMAGE_CHUNKS:
                if fourcc == b"VP8L" and alpha_chunks:
                    raise _Refused("ALPH before VP8L")
                if image_chunks:
                    done = True
                else:
                    size = _bitstream_size(fourcc, self.buf[chunk_start + 8 : chunk_start + chunk_size], payload)
                    if size is None:
                        raise _Refused(f"broken {fourcc.decode().strip()} header")
                    image_chunks = 1
                    frame.image, (frame.width, frame.height) = (chunk_start, chunk_size), size
                    frame.number, frame.complete = number, True
                    self.start += padded
            else:  # a second ALPH, or another chunk: the frame ends before it
                done = True
            if done:
                self.start -= 8
            if self.start == self.riff_end:
                return
            if self.left() < 8:
                raise _Refused("trailing bytes shorter than a chunk header")
            if done:
                return

    def add_frame(self, frame: Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Refused("a frame after an incomplete one")
        self.frames.append(frame)

    def parse_single_image(self) -> None:
        if self.frames:
            raise _Refused("a second image")
        self._check_size(8)
        frame = Frame()
        self.store_frame(1, 0, frame)
        if not self.flags & _ALPHA:
            frame.alpha = (0, 0)  # an ALPH chunk without the VP8X alpha flag is ignored
        if not self.extended and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
        self.add_frame(frame)

    def parse_vp8x(self) -> None:
        self.extended = True
        self.start += 4
        size = self.take(4)
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            raise _Refused(f"VP8X chunk of {size} bytes")
        size += size & 1
        self._check_size(size)
        self.flags = self.take(1)
        self.start += 3
        self.canvas = (1 + self.take(3), 1 + self.take(3))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            raise _Refused(f"canvas {self.canvas}")
        self.start += size - 10
        self._check_size(8)
        self.parse_vp8x_chunks()

    def parse_vp8x_chunks(self) -> None:
        animation = bool(self.flags & _ANIMATION)
        anim_chunks = 0
        while True:
            chunk_start = self.start
            fourcc, size = self.buf[self.start : self.start + 4], int.from_bytes(
                self.buf[self.start + 4 : self.start + 8], "little")
            self.start += 8
            if size > _MAX_CHUNK_PAYLOAD:
                raise _Refused("chunk size")
            padded = size + (size & 1)
            self._check_size(padded)
            if fourcc == b"VP8X":
                raise _Refused("a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise _Refused("an image outside ANMF in an animation")
                self.start = chunk_start
                self.parse_single_image()
            elif fourcc == b"ANIM":  # the first gives the background and loop count; later ones are skipped
                if padded < 6:
                    raise _Refused("ANIM chunk")
                anim_chunks = 1
                self.start += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    raise _Refused("ANMF before ANIM")
                self.parse_frame(padded)
            else:  # ICCP, EXIF, XMP, a second ANIM, unknown chunks
                self.start += padded
            if self.start == self.riff_end:
                return
            if self.left() < 8:
                raise _Refused("trailing bytes shorter than a chunk header")

    def parse_frame(self, chunk_size: int) -> None:  # ParseAnimationFrame
        if 16 > self.left() or chunk_size < 16:
            raise _Refused("ANMF chunk")
        frame = Frame()
        frame.x, frame.y = 2 * self.take(3), 2 * self.take(3)
        frame.width, frame.height = 1 + self.take(3), 1 + self.take(3)
        self.start += 4  # duration, then the dispose and blend bits
        if frame.width * frame.height >= _MAX_IMAGE_AREA:
            raise _Refused("ANMF frame size")
        start = self.start
        self.store_frame(len(self.frames) + 1, chunk_size - 16, frame)
        if self.start - start > chunk_size - 16:
            raise _Refused("a frame past its ANMF chunk")
        if self.flags & _ANIMATION and frame.number > 0:
            self.add_frame(frame)

    # -- validity --------------------------------------------------------- #
    def check_simple(self) -> None:
        if not self.frames or self.canvas[0] <= 0 or self.canvas[1] <= 0:
            raise _Refused("no image")
        if self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise _Refused("no image")

    def check_extended(self) -> None:
        animation = bool(self.flags & _ANIMATION)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise _Refused("no image")
        if self.flags & ~_VALID_FLAGS:
            raise _Refused(f"VP8X flags {self.flags:#x}")
        for f in self.frames:
            if not animation and f.number > 1:
                raise _Refused("frames in a still image")
            if not f.complete:
                raise _Refused("an incomplete frame")
            if f.alpha[1] and f.alpha[0] > f.image[0]:
                raise _Refused("ALPH after the image")
            if f.width <= 0 or f.height <= 0:
                raise _Refused("a frame without size")
            if not animation and (f.x or f.y or (f.width, f.height) != self.canvas):
                raise _Refused(f"a still image of {f.width}x{f.height} on a {self.canvas[0]}x{self.canvas[1]} canvas")
            if animation and (f.x + f.width > self.canvas[0] or f.y + f.height > self.canvas[1]):
                raise _Refused("a frame outside the canvas")


def read_header(data: bytes, name: str) -> Header:
    """The canvas and first frame of a WebP file, every chunk and frame header checked as libwebp's
    animation decoder checks them (WebPGetFeatures on the whole file, then the demuxer); no pixel is
    decoded."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise DecodeError(f"{name}: not a WebP file (no RIFF/WEBP header)")
    try:
        _check_features(data)
        demux = _Demuxer(data)
        demux.parse()
    except _Refused as exc:
        raise DecodeError(f"{name}: broken WebP file ({exc})") from None
    frame = next(f for f in demux.frames if f.number == 1)
    return Header(demux.canvas[0], demux.canvas[1], frame, demux.buf)


# --------------------------------------------------------------------------- #
# The bitstreams (C++) and the conversion (torch)
# --------------------------------------------------------------------------- #
_P, _SZ, _I = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int


def _lossless_lib() -> ctypes.CDLL:
    return native_decoder.library("webp_lossless", {
        "sl_vp8l_decode": [ctypes.c_char_p, _SZ, _P, _I, _I],
        "sl_alph_decode": [ctypes.c_char_p, _SZ, _P, _I, _I],
    })


def _lossy_lib() -> ctypes.CDLL:
    return native_decoder.library("webp_lossy", {"sl_vp8_decode": [ctypes.c_char_p, _SZ, _P, _P, _P, _I, _I]})


def decode_lossless(bitstream: bytes, width: int, height: int, name: str) -> np.ndarray:
    """A VP8L payload → (height, width) uint32 ARGB words (``csrc/webp_lossless.cpp``)."""
    argb = np.empty((height, width), dtype=np.uint32)
    if _lossless_lib().sl_vp8l_decode(bitstream, len(bitstream), argb.ctypes.data, width, height) != 0:
        raise DecodeError(f"{name}: broken WebP lossless bitstream")
    return argb


def decode_alpha(alph: bytes, width: int, height: int, name: str) -> np.ndarray:
    """An ALPH payload → (height, width) uint8 alpha (``csrc/webp_lossless.cpp``)."""
    alpha = np.empty((height, width), dtype=np.uint8)
    if _lossless_lib().sl_alph_decode(alph, len(alph), alpha.ctypes.data, width, height) != 0:
        raise DecodeError(f"{name}: broken WebP alpha data")
    return alpha


def decode_lossy(bitstream: bytes, width: int, height: int, name: str) -> np.ndarray:
    """A VP8 payload → one uint8 buffer: the Y plane (height × width), then U and V
    (ceil(height/2) × ceil(width/2) each) (``csrc/webp_lossy.cpp``)."""
    luma, chroma = width * height, ((width + 1) // 2) * ((height + 1) // 2)
    planes = np.empty(luma + 2 * chroma, dtype=np.uint8)
    base = planes.ctypes.data
    if _lossy_lib().sl_vp8_decode(bitstream, len(bitstream), base, base + luma, base + luma + chroma, width,
                                  height) != 0:
        raise DecodeError(f"{name}: broken WebP lossy bitstream")
    return planes


def _horizontal(n: torch.Tensor, f: torch.Tensor, width: int) -> torch.Tensor:
    """(..., uw) chroma rows, each with its nearer row ``n`` and farther row ``f`` → (..., width): libwebp's
    UpsampleRgbLinePair across a row. Each output between two chroma columns mixes the four samples
    9:3:3:1 through libwebp's two rounded averages; the edge columns take (3·near + far + 2) >> 2."""
    out = torch.empty((*n.shape[:-1], width), dtype=torch.int32, device=n.device)
    edge = (3 * n + f + 2) >> 2
    out[..., 0] = edge[..., 0]
    pairs = (width - 1) // 2
    if pairs:
        n0, n1, f0, f1 = n[..., :pairs], n[..., 1 : pairs + 1], f[..., :pairs], f[..., 1 : pairs + 1]
        mix = n0 + n1 + f0 + f1 + 8
        out[..., 1 : 2 * pairs : 2] = (((mix + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[..., 2 : 2 * pairs + 1 : 2] = (((mix + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if width % 2 == 0:
        out[..., width - 1] = edge[..., -1]
    return out


def _upsample(c: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., ceil(h/2), ceil(w/2)) int32 chroma → (..., h, w): libwebp's fancy upsampler (EmitFancyRGB).

    Luma row 0 takes chroma row 0 alone; rows 2k − 1 and 2k take chroma rows
    k − 1 and k, the nearer weighted 3 and the other 1; the last row of an
    even height takes the last chroma row alone.
    """
    uh = c.shape[-2]
    near = torch.cat([c[..., :1, :], c[..., :-1, :], c[..., 1:, :], c[..., -1:, :]], dim=-2)
    far = torch.cat([c[..., :1, :], c[..., 1:, :], c[..., :-1, :], c[..., -1:, :]], dim=-2)
    rows = _horizontal(near, far, width)
    first, top, bottom, last = rows.split([1, uh - 1, uh - 1, 1], dim=-2)
    pairs = torch.stack([top, bottom], dim=-2).flatten(-3, -2)  # rows 1, 2, 3, 4, …
    return torch.cat([first, pairs, last], dim=-2)[..., :height, :]


def to_rgb(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The uint8 planes of :func:`decode_lossy`, on any device → (height, width, 3) uint8 RGB there:
    libwebp's fancy upsampling and ``VP8YuvToRgb`` (``src/dsp/yuv.h``), in int32."""
    luma, uw, uh = width * height, (width + 1) // 2, (height + 1) // 2
    planes = planes.to(torch.int32)
    y = (planes[:luma].view(height, width) * 19077) >> 8
    u, v = _upsample(planes[luma:].view(2, uh, uw), height, width)
    rgb = torch.stack([y + ((v * 26149) >> 8) - 14234,
                       y - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708,
                       y + ((u * 33050) >> 8) - 17685], dim=-1)
    return (rgb >> 6).clamp_(0, 255).to(torch.uint8)  # libwebp's VP8Clip8: 6 fractional bits


def decode(data: bytes, name: str, device) -> torch.Tensor:
    """WebP bytes → (H, W, 3) uint8 RGB on ``device`` at full resolution, equal to PIL's: the first
    frame on its canvas, RGB zero outside it."""
    header = read_header(data, name)
    check_size(header.width, header.height, name)
    frame = header.frame
    if header.lossless:
        argb = decode_lossless(header.bitstream(), frame.width, frame.height, name)
        # the words' little-endian bytes are B, G, R, A
        rgb = torch.from_numpy(argb.view(np.uint8).reshape(frame.height, frame.width, 4)).to(device)[..., [2, 1, 0]]
    else:
        planes = decode_lossy(header.bitstream(), frame.width, frame.height, name)
        alph = header.alpha()
        if alph is not None:  # libwebp fails the frame when its alpha fails; the alpha itself is dropped
            decode_alpha(alph, frame.width, frame.height, name)
        rgb = to_rgb(torch.from_numpy(planes).to(device), frame.width, frame.height)
    if (frame.width, frame.height) == (header.width, header.height):
        return rgb
    canvas = torch.zeros((header.height, header.width, 3), dtype=torch.uint8, device=rgb.device)
    canvas[frame.y : frame.y + frame.height, frame.x : frame.x + frame.width] = rgb
    return canvas
