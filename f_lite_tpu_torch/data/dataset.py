"""Image dataset of the online training path (counterpart of
`f_lite_tpu/data/dataset.py`): metadata tables, the variable center crop,
aspect buckets and fault-tolerant fetching, on the host in numpy.

Semantics are the JAX package's:
- crop sizes in patch-16 steps sweeping aspect ratios
  (`generate_crop_size_list`), and the crop that keeps the most area
  (`var_center_crop_size_fn`);
- metadata from parquet shards (`*/*/*.parquet`, rows with `media_source`
  "laion" dropped) or a JSON array file (with an `index` column, as
  pandas' `reset_index` gives it);
- backends http(s), s3, dummy and file; a failed fetch gives a black
  placeholder at the row's declared bucket, an empty caption and `_id`
  "-1"; placeholders are refreshed from real images 10% of the time;
- the length rounded down to a multiple of 2048, but never to zero;
- per-item draws (caption pick, flip) from `random.Random` keyed by
  (seed, epoch, index); `collate_fn` replaces minority-shape items by
  majority-shape donors with the global `random`.

Images are uint8 (H, W, 3) arrays, not PIL images. PNG files are read by
the port's own codec (`utils/image.py`); other formats, and a resize
(Lanczos, where an image is not already at its crop's size), need PIL,
imported where it is used. Parquet tables need pandas, the http backend
`requests`, the s3 backend `boto3`, each imported where it is used. This
module imports numpy and no torch: the loader's forkserver preloads it.
"""

from __future__ import annotations

import glob
import io
import json
import logging
import math
import os
import random
from collections import Counter
from pathlib import Path
from typing import Any
from urllib.parse import urlparse

import numpy as np

from f_lite_tpu_torch.data.image_ops import normalize_u8
from f_lite_tpu_torch.utils.image import PNG_SIGNATURE, png_header, read_png, to_rgb

logger = logging.getLogger(__name__)

LENGTH_MULTIPLE = 2048


def generate_crop_size_list(image_size: int, max_ratio: float = 2.0):
    """(w, h) crop sizes in patch-16 steps, from (image_size, image_size *
    max_ratio) to its transpose."""
    assert max_ratio >= 1
    patch = 16
    assert image_size % patch == 0
    min_p = image_size // patch
    max_p = int(image_size * max_ratio) // patch
    sizes = []
    wp, hp = min_p, max_p
    while wp <= max_p and hp >= min_p:
        sizes.append((round(wp * patch), round(hp * patch)))
        wp += 1
        hp -= 1
    return sizes


def _is_valid_crop(cw, ch, w, h, eps=1e-7):
    down = max(cw / w, ch / h)
    return cw <= w * down + eps and ch <= h * down + eps


def var_center_crop_size_fn(orig_wh, image_size, max_ratio=2.0):
    """The crop size keeping the most of an image of size `orig_wh`."""
    w, h = orig_wh[:2]
    candidates = generate_crop_size_list(image_size, max_ratio)
    scored = []
    for cw, ch in candidates:
        if _is_valid_crop(cw, ch, w, h):
            rem = min(cw / w, ch / h) / max(cw / w, ch / h)
            if rem > 0:
                scored.append((rem, (cw, ch)))
    return sorted(scored, reverse=True)[0][1]


def center_crop_arr_simulator(orig_wh, image_size, max_ratio=1.0):
    """The crop size `center_crop_arr` gives, without touching pixels."""
    return var_center_crop_size_fn(orig_wh, image_size, max_ratio)


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "PIL (Pillow) is needed here: to decode an image that is not a PNG "
            "of 8 bits or fewer, or to resize one that is not at its crop's "
            "size") from e
    return Image


def center_crop_arr(arr: np.ndarray, image_size: int,
                    max_ratio: float = 1.0) -> np.ndarray:
    """uint8 (H, W, 3) -> the crop of `var_center_crop_size_fn`, (ch, cw,
    3): scaled so the crop fits (PIL's Lanczos, `reducing_gap` 3.0), then
    cut from the center. An image whose scaled size is its own size is not
    resampled (PIL's resize returns a copy there)."""
    h, w = arr.shape[:2]
    cw, ch = var_center_crop_size_fn((w, h), image_size, max_ratio)
    scale = max(cw / w, ch / h)
    size = tuple(round(x * scale) for x in (w, h))
    if size != (w, h):
        Image = _pil()
        arr = np.asarray(Image.fromarray(np.ascontiguousarray(arr)).resize(
            size, resample=Image.LANCZOS, reducing_gap=3.0))
    # the scaled size covers the crop (scale is the larger ratio), so the
    # cut lies inside the image
    left = (size[0] - cw) // 2
    top = (size[1] - ch) // 2
    return arr[top:top + ch, left:left + cw]


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (H, W, 3) in [-1, 1]."""
    return normalize_u8(arr)


def decode_rgb(data: bytes) -> np.ndarray:
    """Image file bytes -> uint8 (H, W, 3), as PIL's convert("RGB"): PNGs
    the port's codec reads (non-interlaced, 8 bits or fewer) by
    `read_png`; other files by PIL."""
    if data[:8] == PNG_SIGNATURE:
        head = png_header(data)
        depth, ctype = head["bit_depth"], head["color_type"]
        if not head["interlace"] and (
                depth == 8 or (depth in (1, 2, 4) and ctype in (0, 3))):
            return to_rgb(read_png(data))
    Image = _pil()
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(
        v, (bool, np.bool_))


def _table(rows: list[dict]) -> list[dict]:
    """A JSON array of objects as rows of one rectangular table, as
    `pd.DataFrame(rows).reset_index()` holds it: an `index` column first,
    every column in each row (missing cells NaN), and a numeric column
    that holds a float or a missing cell read as floats."""
    columns: dict[str, None] = {}
    for r in rows:
        columns.update(dict.fromkeys(r))
    if "index" in columns:
        raise ValueError("cannot insert index, already exists")
    for col in columns:
        vals = [r[col] for r in rows if col in r]
        if vals and all(_is_number(v) for v in vals) and (
                len(vals) < len(rows)
                or any(isinstance(v, (float, np.floating)) for v in vals)):
            for r in rows:
                if col in r:
                    r[col] = float(r[col])
    return [{"index": i, **{c: r.get(c, math.nan) for c in columns}}
            for i, r in enumerate(rows)]


class ImageDataset:
    """Metadata-table image dataset with bucket-aware fetching."""

    def __init__(
        self,
        data_path: str,
        base_image_dir: str | None = None,
        image_column: str = "media_path",
        caption_column: str = "captions",
        resolution: int = 512,
        center_crop: bool = True,
        random_flip: bool = False,
        root_dir_type: str = "parquet",
        base_url: str = "dummy://",
        retries: int = 3,
        debug: bool = False,
        seed: int = 0,
    ):
        self.image_column = image_column
        self.caption_column = caption_column
        self.resolution = resolution
        self.max_ratio = 1.0 if center_crop else 2.0
        self.random_flip = random_flip
        self.retries = retries
        self.seed = seed
        self.epoch = 0  # advanced by set_epoch (the trainer's epoch loop)
        self.data = self._load_metadata(data_path, base_image_dir,
                                        root_dir_type, debug)

        self.place_holder_image: dict[tuple, np.ndarray] = {
            (w, h): np.zeros((h, w, 3), np.uint8)
            for w, h in generate_crop_size_list(resolution, self.max_ratio)
        }

        self.base_url = urlparse(base_url)
        scheme = self.base_url.scheme or "file"
        self.client = {
            "https": self._http_client,
            "http": self._http_client,
            "s3": self._s3_client,
            "dummy": self._dummy_client,
            "file": self._file_client,
        }.get(scheme)
        if self.client is None:
            raise ValueError(f"Invalid scheme: {scheme}")
        # the dummy backend fabricates pixels at the row's declared bucket,
        # so it alone takes (url, declared_wh)
        self._client_needs_declared_wh = scheme == "dummy"
        self._session = None
        self._s3 = None
        self.aspect_ratio_buckets: dict | None = None

    def __getstate__(self):
        # picklable for the loader's process workers: the lazy HTTP
        # session and boto3 client hold sockets and locks; each worker
        # makes its own on first use
        state = self.__dict__.copy()
        state["_session"] = None
        state["_s3"] = None
        return state

    # ---- metadata -------------------------------------------------------
    def _load_metadata(self, data_path, base_dir, kind, debug) -> list[dict]:
        if kind == "parquet":
            try:
                import pandas as pd
            except ImportError as e:
                raise ImportError("--root_dir_type parquet needs pandas (and a "
                                  "parquet engine); a JSON table does not") from e
            pattern = os.path.join(base_dir or ".", data_path, "*/*/*.parquet")
            files = sorted(glob.glob(pattern))
            if not files:  # flatter layouts too
                files = sorted(glob.glob(os.path.join(
                    base_dir or ".", data_path, "**/*.parquet"), recursive=True))
            frames = []
            size = 0
            for f in files:
                df = pd.read_parquet(f)
                if "media_source" in df.columns:
                    df = df[df["media_source"] != "laion"]
                frames.append(df)
                size += len(df)
                if debug and size > 10240:
                    break
            if not frames:
                raise FileNotFoundError(f"no parquet under {pattern}")
            return pd.concat(frames, ignore_index=True).to_dict("records")
        elif kind == "json":
            p = Path(base_dir or ".") / f"{data_path}.json"
            if not p.exists():
                p = Path(data_path)
            with open(p) as f:
                rows = json.load(f)
            return _table(rows)
        else:
            raise ValueError("root_dir_type must be 'parquet' or 'json'")

    def __len__(self):
        # a multiple of 2048, as the reference rounds, but never zero
        n = len(self.data)
        if n >= LENGTH_MULTIPLE:
            return n // LENGTH_MULTIPLE * LENGTH_MULTIPLE
        return n

    # ---- buckets --------------------------------------------------------
    def setup_aspect_ratio_buckets(self, min_side=None, max_ratio=None):
        """{crop size: [indices]}, the crop of each (width, height) computed
        once."""
        min_side = min_side or self.resolution
        max_ratio = max_ratio or self.max_ratio
        self.aspect_ratio_buckets = {}
        cache: dict[tuple, tuple] = {}
        for idx in range(len(self)):
            row = self.data[idx]
            key = (row["width"], row["height"])
            bucket = cache.get(key)
            if bucket is None:
                bucket = center_crop_arr_simulator(key, min_side, max_ratio)
                cache[key] = bucket
            self.aspect_ratio_buckets.setdefault(bucket, []).append(idx)
        logger.info("created %d aspect buckets: %s",
                    len(self.aspect_ratio_buckets), list(self.aspect_ratio_buckets))
        return self.aspect_ratio_buckets

    # ---- clients --------------------------------------------------------
    def _http_client(self, url):
        import requests
        from requests.adapters import HTTPAdapter, Retry

        if self._session is None:
            self._session = requests.Session()
            retry = Retry(total=self.retries, backoff_factor=0.5,
                          status_forcelist=[429, 500, 502, 503, 504],
                          allowed_methods=["GET"])
            ad = HTTPAdapter(max_retries=retry, pool_connections=200,
                             pool_maxsize=200)
            self._session.mount("http://", ad)
            self._session.mount("https://", ad)
        try:
            url = urlparse(url)._replace(netloc=self.base_url.netloc,
                                         scheme=self.base_url.scheme).geturl()
            r = self._session.get(url, timeout=2, stream=True)
            r.raise_for_status()
            img = decode_rgb(r.content)
            self._maybe_refresh_placeholder(img)
            return img, True
        except ImportError:
            raise
        except Exception as e:  # noqa: BLE001 -- any fetch error -> placeholder
            logger.debug("http fetch failed for %s: %s", url, e)
            return None, False

    def _s3_client(self, url):
        try:
            import boto3
        except ImportError:
            logger.warning("boto3 not installed; s3:// backend unavailable")
            return None, False
        try:
            if self._s3 is None:
                self._s3 = boto3.client(
                    "s3", aws_access_key_id=os.getenv("S3KEY"),
                    aws_secret_access_key=os.getenv("S3SECRET"))
            u = urlparse(url)._replace(netloc=self.base_url.netloc, scheme="s3")
            body = self._s3.get_object(Bucket=u.netloc,
                                       Key=u.path.lstrip("/"))["Body"].read()
            img = decode_rgb(body)
            self._maybe_refresh_placeholder(img)
            return img, True
        except ImportError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.warning("s3 fetch failed for %s: %s", url, e)
            return None, False

    def _file_client(self, url):
        try:
            p = urlparse(url).path if "://" in str(url) else str(url)
            return decode_rgb(Path(p).read_bytes()), True
        except ImportError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.debug("file read failed for %s: %s", url, e)
            return None, False

    def _dummy_client(self, url, declared_wh=None):
        """Hermetic fake backend: noise seeded by the url's `hash` (salted
        per process unless PYTHONHASHSEED is set), at the crop of the
        row's declared size, so the crop is the identity."""
        row_seed = abs(hash(str(url))) % (2**31)
        rs = np.random.RandomState(row_seed)
        w, h = center_crop_arr_simulator(
            declared_wh or (self.resolution, self.resolution),
            self.resolution, self.max_ratio)
        return rs.randint(0, 255, (h, w, 3), np.uint8), True

    def _maybe_refresh_placeholder(self, img):
        if random.random() > 0.9:
            bucket = center_crop_arr_simulator(
                (img.shape[1], img.shape[0]), self.resolution, self.max_ratio)
            self.place_holder_image[bucket] = img

    def set_epoch(self, epoch: int):
        """New per-item draws (flip, caption pick) for the epoch; called
        beside the sampler's `set_epoch`."""
        self.epoch = int(epoch)

    # ---- items ----------------------------------------------------------
    def __getitem__(self, idx: int) -> dict[str, Any]:
        sample = self.data[idx]
        # per-item draws keyed by (seed, epoch, idx): a resumed run draws
        # what the straight run drew, and each epoch draws afresh
        item_rng = random.Random(
            ((self.seed or 0) * 2654435761 + self.epoch) * 1000003 + idx)
        caption = sample.get(self.caption_column, "")
        if isinstance(caption, (tuple, list, np.ndarray)):
            caption = list(caption)
            caption = item_rng.choice(caption) if caption else ""
        if not isinstance(caption, str):
            caption = ""

        declared_wh = (int(sample.get("width", self.resolution)),
                       int(sample.get("height", self.resolution)))
        if self._client_needs_declared_wh:
            img, ok = self.client(sample[self.image_column], declared_wh)
        else:
            img, ok = self.client(sample[self.image_column])
        _id = str(sample.get("source_id", idx))
        if ok:
            img = center_crop_arr(img, self.resolution, self.max_ratio)
            if self.random_flip and item_rng.random() < 0.5:
                img = img[:, ::-1]
            arr = normalize_image(img)
        else:
            ew, eh = center_crop_arr_simulator(declared_wh, self.resolution,
                                               self.max_ratio)
            ph = self.place_holder_image.get((ew, eh))
            if ph is None:
                ph = np.zeros((eh, ew, 3), np.uint8)
            arr = normalize_image(center_crop_arr(ph, self.resolution,
                                                  self.max_ratio))
            _id = "-1"
            caption = ""

        return {
            "image": arr,  # (H, W, 3) float32 in [-1, 1]
            "index": idx,
            "_id": _id,
            "caption": caption,
            "media_source": sample.get("media_source", ""),
            "media_type": sample.get("media_type", "real"),
        }

    # ---- collate --------------------------------------------------------
    def collate_fn(self, batch: list[dict]) -> dict:
        """Stack the items; items of a minority shape are replaced by
        majority-shape donors first."""
        shapes = [s["image"].shape for s in batch]
        if len(set(shapes)) > 1:
            counts = Counter(shapes)
            max_freq = max(counts.values())
            majority = random.choice([s for s, c in counts.items() if c == max_freq])
            donors = [i for i, s in enumerate(shapes) if s == majority]
            for i, s in enumerate(shapes):
                if s != majority:
                    batch[i] = batch[random.choice(donors)]
            shapes = [s["image"].shape for s in batch]
            assert len(set(shapes)) == 1, "failed to homogenize batch"
        out: dict[str, Any] = {}
        for k in batch[0]:
            vals = [s[k] for s in batch]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals, axis=0)
            else:
                out[k] = vals
        return out
