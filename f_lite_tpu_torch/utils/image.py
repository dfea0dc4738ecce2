"""PNG files without PIL (counterpart of `f_lite_tpu/utils/image.py`).

The card's machine has no PIL, so the port writes and reads PNG itself with
numpy, `zlib` and `struct`:
- `png_bytes_with_metadata` / `save_with_metadata` write 8-bit RGB, each
  row under the Up filter, with every generation parameter stamped as the
  JAX package stamps it: an `f-lite:<key>` text chunk for each non-None
  value (tEXt, or iTXt where the text is not Latin-1, as PIL writes it)
  and the JSON blob `f-lite:parameters`;
- `read_png` reads non-interlaced 8-bit gray, gray + alpha, RGB, RGBA and
  palette images (and gray and palette ones of fewer bits) under all five
  row filters; `read_metadata` reads the blob back;
- `load_image` turns a file or its bytes into what the pipeline takes: a
  PNG of the pipeline's size through `read_png`, any other format or size
  through PIL where it is importable (without PIL, a PNG of another size
  is refused from its header);
- every inflate is bounded by what the header declares, so a small file
  cannot inflate to gigabytes.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's caps on compressed text (PngImagePlugin.MAX_TEXT_CHUNK and
# MAX_TEXT_MEMORY): one chunk's text, and all of a file's
MAX_TEXT_CHUNK = 1 << 20
MAX_TEXT_MEMORY = 64 << 20
# samples a pixel for each colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class ImageTooLarge(ValueError):
    """An image whose header declares more pixels than the caller allows."""


class NeedsResize(ValueError):
    """A PNG of another size than the pipeline's where PIL, which the
    pipeline resizes with, is not importable."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _text_chunk(key: str, value: str) -> bytes:
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    except UnicodeEncodeError:
        # uncompressed, no language tag, as PIL's `add_text` falls back
        return _chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0"
                      + value.encode("utf-8"))


def _text_chunks(params: dict) -> list[bytes]:
    clean = {k: v for k, v in params.items() if v is not None}
    return ([_text_chunk(f"f-lite:{k}", str(v)) for k, v in clean.items()]
            + [_text_chunk("f-lite:parameters", json.dumps(clean))])


def png_bytes_with_metadata(image: np.ndarray, params: dict | None = None) -> bytes:
    """uint8 (H, W, 3) -> PNG bytes (8-bit RGB, Up filter on every row,
    zlib level 6), with the generation parameters `params` stamped when
    given."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = image.reshape(h, w * 3)
    up = np.empty((h, w * 3 + 1), np.uint8)
    up[:, 0] = 2  # Up: each byte less the byte above it, mod 256
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join([PNG_SIGNATURE, _chunk(b"IHDR", header),
                     *(_text_chunks(params) if params else []),
                     _chunk(b"IDAT", zlib.compress(up.tobytes(), 6)),
                     _chunk(b"IEND", b"")])


def save_with_metadata(image: np.ndarray, path, params: dict) -> None:
    """Write uint8 (H, W, 3) as a parameter-stamped PNG. Another suffix is
    written plainly through PIL, as the JAX package does, and needs it."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        path.write_bytes(png_bytes_with_metadata(image, params))
        return
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: writing {path.suffix or 'no suffix'} needs "
                         "PIL; use a .png name") from None
    Image.fromarray(np.asarray(image)).save(path)


def _chunks(data: bytes):
    """(kind, payload) of every chunk, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + payload):
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without IEND")


def _inflate(data: bytes, limit: int, what: str) -> bytes:
    """zlib `data` inflated to at most `limit` bytes: data that would
    inflate further raises ValueError before it takes more memory, so a
    small file cannot inflate to gigabytes."""
    try:
        out = zlib.decompressobj().decompress(data, limit + 1)
    except zlib.error as e:
        raise ValueError(f"{what} does not inflate: {e}") from None
    if len(out) > limit:
        raise ValueError(f"{what} inflates past the {limit} bytes it may take")
    return out


def png_header(data: bytes) -> dict:
    """The IHDR fields of PNG bytes, read without decoding a pixel."""
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR" or len(data) < 33:
        raise ValueError("not a PNG file")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return dict(width=w, height=h, bit_depth=depth, color_type=ctype,
                compression=comp, filter=filt, interlace=interlace)


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 255


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 255


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: None and Up in numpy, Sub as a running sum
    of each channel mod 256, Average and Paeth byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = kinds[y]
        if kind == 0:
            out[y] = data[y]
        elif kind == 1:
            out[y] = (np.cumsum(data[y].reshape(-1, bpp), axis=0, dtype=np.uint64)
                      .astype(np.uint8).reshape(-1))
        elif kind == 2:
            np.add(data[y], prev, out=out[y])
        else:
            line = bytearray(data[y].tobytes())
            (_average_row if kind == 3 else _paeth_row)(line, prev.tobytes(), bpp)
            out[y] = np.frombuffer(line, np.uint8)
        prev = out[y]
    return out


def read_png(data: bytes, max_pixels: int | None = None) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C): C = 1 gray, 2 gray + alpha, 3 RGB, 4
    RGBA; a palette image comes out RGB, or RGBA with a tRNS chunk. Gray and
    palette images of 1, 2 or 4 bits a pixel are read too (gray scaled to
    0-255, as PIL reads it). Interlaced and 16-bit images raise ValueError,
    as does a header of more than `max_pixels` pixels (`ImageTooLarge`),
    before any pixel is decoded. The image data is inflated only as far as
    the header's size needs: data that inflates further raises too."""
    head = png_header(data)
    w, h, ctype, depth = (head["width"], head["height"], head["color_type"],
                          head["bit_depth"])
    if max_pixels is not None and w * h > max_pixels:
        raise ImageTooLarge(f"image too large ({w}x{h})")
    if head["interlace"]:
        raise ValueError("interlaced PNG: only non-interlaced images are read")
    if ctype not in _CHANNELS or head["compression"] or head["filter"]:
        raise ValueError(f"unsupported PNG (colour type {ctype})")
    if depth != 8 and not (depth in (1, 2, 4) and ctype in (0, 3)):
        raise ValueError(f"{depth}-bit PNG: only 8-bit images (and 1-, 2- and "
                         "4-bit gray or palette ones) are read")
    if w == 0 or h == 0:
        raise ValueError("PNG has no pixels")
    idat, palette, trns = [], None, None
    for kind, payload in _chunks(data):
        if kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
    c = _CHANNELS[ctype]
    stride = -(-w * c * depth // 8)
    raw = _inflate(b"".join(idat), h * (stride + 1), "PNG image data")
    if depth == 8:
        pixels = _unfilter(raw, h, stride, c).reshape(h, w, c)
    else:
        rows = _unfilter(raw, h, stride, 1)
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        pixels = (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8)[..., None]
        if ctype == 0:
            pixels *= 255 // ((1 << depth) - 1)
    if ctype != 3:
        return pixels
    if palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    index = pixels[..., 0]
    if int(index.max()) >= len(palette):
        raise ValueError("palette index out of range")
    if trns is None:
        return palette[index]
    alpha = np.full(len(palette), 255, np.uint8)
    alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
    return np.concatenate([palette[index], alpha[index][..., None]], axis=-1)


def text_chunks(data: bytes) -> dict:
    """The text of every tEXt, zTXt and iTXt chunk, by keyword. Compressed
    text is held to PIL's caps: ValueError for a chunk that inflates past
    `MAX_TEXT_CHUNK` bytes, or all of them past `MAX_TEXT_MEMORY`."""
    out, budget = {}, MAX_TEXT_MEMORY
    for kind, payload in _chunks(data):
        if kind not in (b"tEXt", b"zTXt", b"iTXt"):
            continue
        key, _, rest = payload.partition(b"\0")
        if kind == b"tEXt":
            text = rest.decode("latin-1")
        elif kind == b"zTXt":
            raw = _inflate(rest[1:], min(MAX_TEXT_CHUNK, budget), "PNG text")
            budget -= len(raw)
            text = raw.decode("latin-1")
        else:
            compressed, rest = rest[0], rest[2:]
            _lang, _, rest = rest.partition(b"\0")
            _translated, _, rest = rest.partition(b"\0")
            if compressed:
                rest = _inflate(rest, min(MAX_TEXT_CHUNK, budget), "PNG text")
                budget -= len(rest)
            text = rest.decode("utf-8")
        out[key.decode("latin-1")] = text
    return out


def read_metadata(path) -> dict:
    """The `f-lite:parameters` blob of a stamped PNG (path or bytes); an
    empty dict without one."""
    data = path if isinstance(path, (bytes, bytearray)) else Path(path).read_bytes()
    raw = text_chunks(bytes(data)).get("f-lite:parameters")
    return json.loads(raw) if raw else {}


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """`read_png`'s (H, W, C) -> (H, W, 3), as PIL's convert("RGB"): gray
    repeated, alpha dropped."""
    c = pixels.shape[-1]
    return np.repeat(pixels[..., :1], 3, axis=-1) if c <= 2 else pixels[..., :3]


def to_luma(pixels: np.ndarray) -> np.ndarray:
    """`read_png`'s (H, W, C) -> (H, W) uint8, as PIL's convert("L"): gray as
    it is, RGB through ITU-R 601-2 luma in PIL's fixed point."""
    if pixels.shape[-1] <= 2:
        return pixels[..., 0].copy()
    r, g, b = (pixels[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _pil_image():
    """PIL's `Image` module, or None where PIL is not importable."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def load_image(src, mode: str = "RGB", max_pixels: int | None = None,
               size: tuple[int, int] | None = None, what: str = "image"):
    """A file path or its bytes -> what the pipeline takes as `image`
    (mode "RGB") or `mask_image` (mode "L"). A PNG becomes a uint8 array,
    (H, W, 3) or (H, W); another format becomes a PIL image in `mode`, and
    needs PIL. Every failure to decode raises ValueError (`ImageTooLarge`
    for a header past `max_pixels`, `NeedsResize` for the size below).

    With `size` = (height, width), the pipeline's size: a PNG of that size
    is read by `read_png`; one of another size goes to PIL, which decodes
    it and with which the pipeline resizes it, and without PIL it is
    refused from its header, before any pixel is decoded. So `read_png`'s
    byte-by-byte filters never run past the requested size."""
    data = src if isinstance(src, (bytes, bytearray)) else Path(src).read_bytes()
    data = bytes(data)
    is_png = data[:8] == PNG_SIGNATURE
    if is_png:
        head = png_header(data)
        w, h = head["width"], head["height"]
        if max_pixels is not None and w * h > max_pixels:
            raise ImageTooLarge(f"image too large ({w}x{h})")
        if size is None or (h, w) == tuple(size):
            pixels = read_png(data)
            return to_rgb(pixels) if mode == "RGB" else to_luma(pixels)
    Image = _pil_image()
    if Image is None and is_png:
        raise NeedsResize(f"{what} is {w}x{h}, not {size[1]}x{size[0]}; "
                          "resizing it needs PIL")
    if Image is None:
        raise ValueError("not a PNG file (reading other formats needs PIL)")
    import io

    from PIL import UnidentifiedImageError

    try:
        img = Image.open(io.BytesIO(data))
        if max_pixels is not None and img.width * img.height > max_pixels:
            raise ImageTooLarge(f"image too large ({img.width}x{img.height})")
        img.load()
    except Image.DecompressionBombError:
        raise ImageTooLarge("image too large") from None
    except (UnidentifiedImageError, OSError) as e:
        raise ValueError(str(e)) from None
    return img.convert(mode)


def make_image_grid(images, nrow: int = 3, padding: int = 2) -> np.ndarray:
    """uint8 images (a list or an (N, H, W, 3) array) tiled into one uint8
    (H', W', 3) grid, `nrow` to a row with black `padding` between them."""
    images = [np.asarray(i) for i in images]
    if not images:
        raise ValueError("no images to grid")
    h, w = images[0].shape[:2]
    ncol = min(nrow, len(images))
    nrows = -(-len(images) // ncol)
    grid = np.zeros((nrows * h + (nrows - 1) * padding,
                     ncol * w + (ncol - 1) * padding, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, ncol)
        y, x = r * (h + padding), c * (w + padding)
        # as PIL's paste: what falls past the grid's edge is cut off
        part = img[:grid.shape[0] - y, :grid.shape[1] - x]
        grid[y:y + part.shape[0], x:x + part.shape[1]] = part
    return grid
