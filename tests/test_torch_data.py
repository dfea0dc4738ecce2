"""The port's image input path against the JAX package's, on the CPU: crop
lists and crop choice, the crop's pixels (an identity crop and PIL's
Lanczos resize), the host normalize against the JAX package's native
library, `ImageDataset` items from one JSON table (dummy and file backends:
PNG, gray PNG and JPEG files, a missing file, list captions, laion rows,
`random_flip`) at epochs 0 and 1, the aspect buckets and `collate_fn`, and
the loader (thread and process workers, an abandoned iterator, a failing
pool, the torch-free forkserver preload). Every comparison is exact: the
images are bit-equal float32 arrays."""

import io
import json
import math
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from f_lite_tpu import native
from f_lite_tpu.data import dataset as jds
from f_lite_tpu.data.loader import DataLoader as JaxDataLoader
from f_lite_tpu_torch.data import dataset as tds
from f_lite_tpu_torch.data import image_ops
from f_lite_tpu_torch.data.loader import DataLoader
from f_lite_tpu_torch.data.samplers import ResolutionBucketSampler
from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

ROOT = Path(__file__).resolve().parent.parent

SIZES = [(64, 64), (80, 112), (112, 80), (100, 75), (75, 100), (300, 700),
         (640, 480), (512, 512), (1024, 768), (33, 200), (130, 131)]


@pytest.mark.parametrize("image_size", [64, 128, 256, 512])
@pytest.mark.parametrize("max_ratio", [1.0, 1.5, 2.0])
def test_crop_lists_and_crop_choice_match_jax(image_size, max_ratio):
    assert tds.generate_crop_size_list(image_size, max_ratio) == \
        jds.generate_crop_size_list(image_size, max_ratio)
    for wh in SIZES:
        assert tds.var_center_crop_size_fn(wh, image_size, max_ratio) == \
            jds.var_center_crop_size_fn(wh, image_size, max_ratio), wh
        assert tds.center_crop_arr_simulator(wh, image_size, max_ratio) == \
            jds.center_crop_arr_simulator(wh, image_size, max_ratio), wh


@pytest.mark.parametrize("wh, size, ratio", [
    ((64, 64), 64, 1.0),      # identity: no resample
    ((80, 112), 64, 2.0),     # identity at a non-square bucket
    ((100, 75), 64, 1.0),     # Lanczos down, then a center cut
    ((48, 40), 64, 2.0),      # Lanczos up
    ((64, 70), 64, 1.0),      # scale 1, a center cut only
])
def test_center_crop_pixels_match_jax(wh, size, ratio):
    arr = np.random.RandomState(wh[0] * wh[1]).randint(0, 256, (wh[1], wh[0], 3)
                                                       ).astype(np.uint8)
    want = np.asarray(jds.center_crop_arr(Image.fromarray(arr), size, ratio))
    got = tds.center_crop_arr(arr, size, ratio)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_normalize_is_bit_equal_to_the_native_route():
    every = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    np.testing.assert_array_equal(image_ops.normalize_u8(every),
                                  native.normalize_u8(every))
    imgs = np.random.RandomState(1).randint(0, 256, (4, 6, 10, 3)).astype(np.uint8)
    flip = np.array([1, 0, 0, 1], np.uint8)
    got = image_ops.normalize_batch_u8(imgs, flip)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, native.normalize_batch_u8(imgs, flip))
    np.testing.assert_array_equal(image_ops.normalize_batch_u8(imgs),
                                  native.normalize_batch_u8(imgs))
    x = np.random.RandomState(2).uniform(-1.3, 1.3, (4, 8, 8, 3)).astype(np.float32)
    halves = ((np.arange(256, dtype=np.float32) + 0.5) / 127.5 - 1.0)
    for arr in (x, halves, image_ops.normalize_u8(every)):
        np.testing.assert_array_equal(image_ops.denormalize_to_u8(arr),
                                      native.denormalize_to_u8(arr))


def _png(path: Path, arr: np.ndarray):
    path.write_bytes(png_bytes_with_metadata(arr))


def _write_table(root: Path) -> Path:
    """A JSON table of 14 rows: RGB PNGs at and off their crop's size, a
    gray PNG, a JPEG, a missing file, list and plain captions, laion rows
    and a source_id column with a gap."""
    rs = np.random.RandomState(5)
    rows = []
    decl = [(64, 128), (80, 112), (96, 96), (112, 80), (100, 75), (64, 64), (50, 90)]
    for i in range(14):
        w, h = decl[i % len(decl)]
        f = root / f"img_{i}.png"
        if i == 3:
            gray = rs.randint(0, 256, (h, w)).astype(np.uint8)
            Image.fromarray(gray, "L").save(f)
        elif i == 5:
            f = root / f"img_{i}.jpg"
            Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(f)
        elif i != 9:  # row 9's file is missing
            _png(f, rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        row = {"media_path": str(f) if i % 2 else f"file://{f}",
               "captions": [f"caption {i}", f"alt {i}", f"third {i}"]
               if i % 3 else f"plain {i}",
               "width": w, "height": h,
               "media_source": "laion" if i % 4 == 0 else "freepik"}
        if i != 7:
            row["source_id"] = 1000 + i
        rows.append(row)
    path = root / "table.json"
    path.write_text(json.dumps(rows))
    return path


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("base_url", ["file://", "dummy://"])
def test_image_dataset_items_match_jax(tmp_path, base_url):
    table = _write_table(tmp_path)
    kw = dict(root_dir_type="json", base_url=base_url, resolution=64,
              center_crop=False, random_flip=True, seed=3)
    want_ds = jds.ImageDataset(str(table), **kw)
    got_ds = tds.ImageDataset(str(table), **kw)
    assert len(got_ds) == len(want_ds) == 14
    placeholders = 0
    for epoch in (0, 1):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in range(len(want_ds)):
            want, got = want_ds[i], got_ds[i]
            assert got["image"].dtype == np.float32
            np.testing.assert_array_equal(got["image"], want["image"],
                                          err_msg=f"item {i} epoch {epoch}")
            for key in ("caption", "_id", "index", "media_source", "media_type"):
                assert _same(got[key], want[key]), (i, key, got[key], want[key])
            placeholders += got["_id"] == "-1"
    assert placeholders == (2 if base_url == "file://" else 0)


def test_buckets_and_collate_match_jax(tmp_path):
    table = _write_table(tmp_path)
    kw = dict(root_dir_type="json", base_url="dummy://", resolution=64,
              center_crop=False, seed=1)
    want_ds = jds.ImageDataset(str(table), **kw)
    got_ds = tds.ImageDataset(str(table), **kw)
    want = want_ds.setup_aspect_ratio_buckets()
    got = got_ds.setup_aspect_ratio_buckets()
    assert list(got.items()) == [(tuple(int(x) for x in k), v) for k, v in want.items()]
    idx = [0, 1, 2, 6, 7, 8, 13]  # three shapes, one of them twice
    for seed in range(4):
        random.seed(seed)
        want_b = want_ds.collate_fn([want_ds[i] for i in idx])
        random.seed(seed)
        got_b = got_ds.collate_fn([got_ds[i] for i in idx])
        np.testing.assert_array_equal(got_b["image"], want_b["image"])
        assert got_b["_id"] == want_b["_id"] and got_b["caption"] == want_b["caption"]


def test_parquet_table_rows_match_jax(tmp_path):
    import pandas as pd

    rows = [{"source_id": f"img{i}", "media_path": f"dummy://b/{i}.jpg",
             "captions": [f"c{i}", f"d{i}"], "width": 64 + 16 * (i % 3),
             "height": 64, "media_source": "laion" if i % 4 == 0 else "x"}
            for i in range(10)]
    (tmp_path / "coll" / "a" / "b").mkdir(parents=True)
    pd.DataFrame(rows).to_parquet(tmp_path / "coll" / "a" / "b" / "p.parquet")
    kw = dict(base_image_dir=str(tmp_path), resolution=64, center_crop=False, seed=2)
    want_ds = jds.ImageDataset("coll", **kw)
    got_ds = tds.ImageDataset("coll", **kw)
    assert len(got_ds) == len(want_ds) == 7  # the laion rows dropped
    for i in range(len(got_ds)):
        want, got = want_ds[i], got_ds[i]
        np.testing.assert_array_equal(got["image"], want["image"])
        assert (got["caption"], got["_id"]) == (want["caption"], want["_id"])


def _loader_pair(tmp_path, **kw):
    table = _write_table(tmp_path)
    args = dict(root_dir_type="json", base_url="file://", resolution=64,
                center_crop=True, random_flip=True, seed=4)
    return (JaxDataLoader(jds.ImageDataset(str(table), **args), **kw),
            DataLoader(tds.ImageDataset(str(table), **args), **kw))


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_loader_batches_match_jax(tmp_path, worker_type):
    sampler = [11, 2, 7, 0, 13, 5, 9, 4, 1]
    jdl, tdl = _loader_pair(tmp_path, batch_size=4, sampler=sampler,
                            num_workers=2, drop_last=True, worker_type=worker_type)
    want, got = list(jdl), list(tdl)
    assert len(got) == len(want) == len(tdl) == 2
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["caption"] == w["caption"] and g["_id"] == w["_id"]
        assert g["index"] == w["index"]


def test_bucket_loader_batches_match_jax(tmp_path):
    table = _write_table(tmp_path)
    args = dict(root_dir_type="json", base_url="dummy://", resolution=64,
                center_crop=False, seed=4)
    from f_lite_tpu.data.samplers import ResolutionBucketSampler as JaxBuckets

    jds_ = jds.ImageDataset(str(table), **args)
    tds_ = tds.ImageDataset(str(table), **args)
    jdl = JaxDataLoader(jds_, batch_sampler=JaxBuckets(jds_, 2, seed=4), num_workers=2)
    tdl = DataLoader(tds_, batch_sampler=ResolutionBucketSampler(tds_, 2, seed=4),
                     num_workers=2)
    want, got = list(jdl), list(tdl)
    assert len(got) == len(want) == len(tdl) > 0
    for w, g in zip(want, got):
        assert g["image"].shape[0] == 2
        np.testing.assert_array_equal(g["image"], w["image"])


def test_abandoned_iterator_releases_the_producer(tmp_path):
    _, tdl = _loader_pair(tmp_path, batch_size=2, num_workers=2, prefetch=1)
    before = threading.active_count()
    for _ in range(3):
        it = iter(tdl)
        next(it)
        it.close()
    deadline = time.time() + 10
    while time.time() < deadline and threading.active_count() > before:
        time.sleep(0.1)
    assert threading.active_count() <= before


def test_pool_failure_and_worker_errors_reach_the_consumer(tmp_path, monkeypatch):
    _, tdl = _loader_pair(tmp_path, batch_size=2, num_workers=2)

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"item {i}")

    with pytest.raises(KeyError, match="item"):
        next(iter(DataLoader(Broken(), batch_size=2, num_workers=2)))

    def boom(self):
        raise OSError("no pipes left")

    monkeypatch.setattr(DataLoader, "_make_pool", boom)
    with pytest.raises(OSError, match="no pipes left"):
        next(iter(tdl))


def test_forkserver_preload_imports_no_torch():
    """The one module the forkserver preloads imports neither torch nor
    the JAX package: torch in the server would bring back the
    fork-with-threads hazard."""
    code = ("import sys; import f_lite_tpu_torch.data.dataset; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'f_lite_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin:/usr/local/bin",
                            "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, (r.stdout, r.stderr[-1000:])


def test_decode_reads_pngs_itself_and_other_formats_through_pil(tmp_path):
    rs = np.random.RandomState(9)
    rgb = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tds.decode_rgb(png_bytes_with_metadata(rgb)), rgb)
    for mode, arr in (("L", rgb[..., 0]), ("RGBA", np.dstack([rgb, rgb[..., :1]]))):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(tds.decode_rgb(buf.getvalue()), want)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="BMP")
    np.testing.assert_array_equal(tds.decode_rgb(buf.getvalue()), rgb)
