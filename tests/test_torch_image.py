"""The port's PNG codec (`f_lite_tpu_torch/utils/image.py`, no PIL) against
PIL and the JAX package's `f_lite_tpu/utils/image.py`, on seeded images."""

import io
import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from f_lite_tpu.utils import image as jimage
from f_lite_tpu_torch.utils import image as timage

PARAMS = {"prompt": "a red circle", "negative_prompt": None, "width": 40,
          "height": 24, "steps": 30, "guidance_scale": 6.0, "seed": 7,
          "guidance_interval": [0.1, 0.9], "sampler": "ab2",
          "note": "café ☕ 画像"}


def _image(h=24, w=40, c=3, seed=0):
    """Smooth seeded image (runs of equal and slowly changing bytes), so
    PIL's filter choice varies from row to row."""
    rs = np.random.RandomState(seed)
    x = np.cumsum(rs.randint(-4, 5, (h, w, c)), axis=1) + rs.randint(0, 256, (1, 1, c))
    return (x % 256).astype(np.uint8)


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_row(kind, line, prev, bpp):
    """PNG's forward filter of one row (the inverse of what the reader
    undoes), in Python ints."""
    out = bytearray(len(line))
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (line[i] - pred) & 255
    return bytes([kind]) + bytes(out)


def _png_with_filters(pixels: np.ndarray, kinds) -> bytes:
    """An 8-bit PNG of `pixels` (H, W, C) whose row y takes filter
    kinds[y % len(kinds)]: PIL chooses its filters itself."""
    h, w, c = pixels.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    prev = bytes(w * c)
    raw = b""
    for y in range(h):
        line = pixels[y].tobytes()
        raw += _filter_row(kinds[y % len(kinds)], line, prev, c)
        prev = line
    return (timage.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_port_png_decodes_in_pil_to_the_same_pixels():
    x = _image()
    data = timage.png_bytes_with_metadata(x)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB" and im.size == (40, 24)
        np.testing.assert_array_equal(np.asarray(im), x)
    np.testing.assert_array_equal(timage.read_png(data), x)


def test_metadata_reads_back_in_both_packages(tmp_path):
    """Each parameter under `f-lite:<key>` as JAX stamps it (tEXt, iTXt
    where the text is not Latin-1), the JSON blob readable by JAX's
    `read_metadata` and the port's."""
    x = _image(seed=1)
    path = tmp_path / "stamped.png"
    timage.save_with_metadata(x, path, PARAMS)
    want = {k: v for k, v in PARAMS.items() if v is not None}
    assert jimage.read_metadata(path) == want
    assert timage.read_metadata(path) == want
    # the JAX package's stamp of the same image, read by both
    jpath = tmp_path / "jax.png"
    jimage.save_with_metadata(Image.fromarray(x), jpath, PARAMS)
    assert timage.read_metadata(jpath) == want
    ours = timage.text_chunks(path.read_bytes())
    with Image.open(jpath) as im:
        assert ours == {k: v for k, v in im.info.items() if k.startswith("f-lite:")}
    with Image.open(path) as im:
        assert ours == {k: v for k, v in im.info.items() if k.startswith("f-lite:")}
    # the HTTP path's bytes carry the same stamp
    data = timage.png_bytes_with_metadata(x, PARAMS)
    assert timage.read_metadata(data) == want
    assert timage.read_metadata(timage.png_bytes_with_metadata(x)) == {}


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P_trns", "P4", "1"])
def test_read_png_of_pil_written_images(mode):
    """Every colour type PIL writes; "P4" (16 colours) and "1" come out of
    PIL at 4 and 1 bits a pixel."""
    x = _image(c=4, seed=2)
    if mode == "P_trns":
        img = Image.fromarray(x[..., :3]).quantize(64)
        data = _pil_png(img, transparency=3)
    elif mode in ("P", "P4"):
        img = Image.fromarray(x[..., :3]).quantize(64 if mode == "P" else 16)
        data = _pil_png(img)
    else:
        img = Image.fromarray(x).convert(mode)
        data = _pil_png(img)
    head = timage.png_header(data)
    assert (head["color_type"], head["bit_depth"]) == {
        "L": (0, 8), "LA": (4, 8), "RGB": (2, 8), "RGBA": (6, 8), "P": (3, 8),
        "P_trns": (3, 8), "P4": (3, 4), "1": (0, 1)}[mode]
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert({"P_trns": "RGBA", "P": "RGB", "P4": "RGB",
                                      "1": "L"}.get(mode, mode)))
    got = timage.read_png(data)
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    # what the pipeline is handed, as PIL would convert it
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(timage.to_rgb(got) if mode != "P_trns"
                                      else got[..., :3], np.asarray(im.convert("RGB")))
        np.testing.assert_array_equal(timage.to_luma(got), np.asarray(im.convert("L")))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 1, 3, 0, 2)])
def test_read_png_undoes_each_filter(channels, kinds):
    x = _image(h=9, w=13, c=channels, seed=channels)
    data = _png_with_filters(x, kinds)
    np.testing.assert_array_equal(timage.read_png(data), x)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(x.shape), x)


def test_interlaced_and_16_bit_raise():
    x = _image(seed=3)
    with pytest.raises(ValueError, match="interlaced"):
        timage.read_png(_interlaced(x))  # PIL writes no interlaced PNG
    img16 = Image.fromarray(x[..., 0].astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="16-bit"):
        timage.read_png(_pil_png(img16))
    with pytest.raises(ValueError, match="not a PNG"):
        timage.read_png(b"hello")
    data = bytearray(timage.png_bytes_with_metadata(x))
    data[-20] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError):
        timage.read_png(bytes(data))
    huge = (timage.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 100_000, 100_000, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"")) + _chunk(b"IEND", b""))
    with pytest.raises(timage.ImageTooLarge):
        timage.read_png(huge, max_pixels=4096 * 4096)


def _interlaced(x):
    """The header of an Adam7 PNG (the reader refuses it before the data)."""
    h, w, _ = x.shape
    return (timage.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(b"\0" * (h * (w * 3 + 1))))
            + _chunk(b"IEND", b""))


def test_load_image_and_fit(tmp_path):
    x = _image(seed=4)
    f = tmp_path / "in.png"
    f.write_bytes(timage.png_bytes_with_metadata(x))
    np.testing.assert_array_equal(timage.load_image(f), x)
    with Image.open(f) as im:
        np.testing.assert_array_equal(timage.load_image(f, "L"), np.asarray(im.convert("L")))
    np.testing.assert_array_equal(timage.load_image(f, size=(24, 40)), x)
    # another size: PIL decodes it, and the pipeline resizes it with PIL
    resized = timage.load_image(f, size=(16, 16))
    assert isinstance(resized, Image.Image) and resized.size == (40, 24)
    np.testing.assert_array_equal(np.asarray(resized), x)
    jpg = io.BytesIO()
    Image.fromarray(x).save(jpg, "JPEG")
    got = timage.load_image(jpg.getvalue())
    assert isinstance(got, Image.Image) and got.mode == "RGB"
    with pytest.raises(ValueError):
        timage.load_image(b"hello")


def test_without_pil_another_size_is_refused_from_the_header(monkeypatch):
    """Without PIL a PNG of another size than the pipeline's is refused
    before a pixel is decoded: image data that does not inflate at all
    still gives the size error."""
    monkeypatch.setattr(timage, "_pil_image", lambda: None)
    x = _image(seed=4)
    good = timage.png_bytes_with_metadata(x)
    np.testing.assert_array_equal(timage.load_image(good, size=(24, 40)), x)
    garbage = (timage.PNG_SIGNATURE
               + _chunk(b"IHDR", struct.pack(">IIBBBBB", 40, 24, 8, 2, 0, 0, 0))
               + _chunk(b"IDAT", b"not zlib") + _chunk(b"IEND", b""))
    with pytest.raises(timage.NeedsResize, match="--image is 40x24, not 16x16"):
        timage.load_image(garbage, size=(16, 16), what="--image")
    with pytest.raises(ValueError, match="does not inflate") as e:
        timage.load_image(garbage, size=(24, 40))
    assert not isinstance(e.value, timage.NeedsResize)


def _bomb_png(w=16, h=16, inflated=32 << 20):
    """A w x h RGB header over image data that inflates to `inflated` zero
    bytes (the header needs h * (3w + 1))."""
    return (timage.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(inflated), 9)) + _chunk(b"IEND", b""))


def test_image_data_inflates_only_as_far_as_the_header_needs():
    """A small file whose image data inflates far past its header's size
    raises without the memory to inflate it all."""
    import tracemalloc

    bomb = _bomb_png()
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="inflates past"):
            timage.read_png(bomb)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak
    with pytest.raises(ValueError, match="inflates past"):
        timage.load_image(bomb, size=(16, 16))
    exact = _bomb_png(inflated=16 * (3 * 16 + 1))
    np.testing.assert_array_equal(timage.read_png(exact), np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="truncated"):
        timage.read_png(_bomb_png(inflated=16 * (3 * 16 + 1) - 1))


def test_compressed_text_is_held_to_pils_caps(monkeypatch):
    base = timage.png_bytes_with_metadata(_image(seed=7))

    def with_chunks(*chunks):
        return base[:33] + b"".join(chunks) + base[33:]  # after IHDR

    small = with_chunks(_chunk(b"zTXt", b"a\0\0" + zlib.compress(b"fine")),
                        _chunk(b"iTXt", b"b\0\1\0\0\0" + zlib.compress("ok ☕".encode())))
    assert timage.text_chunks(small) == {"a": "fine", "b": "ok ☕"}
    over = zlib.compress(bytes(timage.MAX_TEXT_CHUNK + 1), 9)
    for bomb in (_chunk(b"zTXt", b"a\0\0" + over), _chunk(b"iTXt", b"b\0\1\0\0\0" + over)):
        with pytest.raises(ValueError, match="inflates past"):
            timage.text_chunks(with_chunks(bomb))
        with pytest.raises(ValueError, match="inflates past"):
            timage.read_metadata(with_chunks(bomb))
    monkeypatch.setattr(timage, "MAX_TEXT_MEMORY", 6)
    with pytest.raises(ValueError, match="inflates past"):
        timage.text_chunks(small)  # 4 + 6 bytes of text past a budget of 6


def test_make_image_grid_equals_jax():
    rs = np.random.RandomState(5)
    images = [rs.randint(0, 256, (6, 10, 3)).astype(np.uint8) for _ in range(5)]
    for nrow, padding in ((3, 2), (2, 0), (5, 1), (8, 3)):
        want = np.asarray(jimage.make_image_grid([Image.fromarray(i) for i in images],
                                                 nrow=nrow, padding=padding))
        np.testing.assert_array_equal(
            timage.make_image_grid(images, nrow=nrow, padding=padding), want)
    with pytest.raises(ValueError):
        timage.make_image_grid([])


def test_json_blob_is_jax_stamp_for_the_same_params(tmp_path):
    """The blob is byte for byte the JAX package's."""
    x = _image(seed=6)
    timage.save_with_metadata(x, tmp_path / "a.png", PARAMS)
    jimage.save_with_metadata(Image.fromarray(x), tmp_path / "b.png", PARAMS)
    blob = timage.text_chunks((tmp_path / "a.png").read_bytes())["f-lite:parameters"]
    with Image.open(tmp_path / "b.png") as im:
        assert blob == im.info["f-lite:parameters"]
    assert json.loads(blob)["note"] == PARAMS["note"]
