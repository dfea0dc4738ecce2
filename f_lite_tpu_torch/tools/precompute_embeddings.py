"""Offline precompute of the training cache: VAE latents and text
embeddings (counterpart of the repo tool `tools/precompute_embeddings.py`).

    python -m f_lite_tpu_torch.tools.precompute_embeddings \\
        --train_data_path table.json --root_dir_type json \\
        --base_url file:// --resolution 256 --center_crop \\
        --vae_path /ckpt/vae --text_encoder_type t5 \\
        --text_encoder_path /ckpt/text_encoder --output_dir /cache

Iterates an `ImageDataset` in batches of `--batch_size` (the partial last
batch kept), encodes each batch's images through the VAE (a posterior
sample, normalized; fp32, TF32 off, no autograd) and its captions through
the text encoder, and writes the cache that `train --use_precomputed_data`
and `serve --precomputed_dir` read (`data/precomputed.py`: one latent per
item, one embedding per caption, deduplicated by the caption's md5, each
embedding only its real rows). `--limit N` stops after N items, mid-batch.

The options and defaults are the JAX tool's, plus `--device`: the encoders
run on the card unless `--device cpu` is given, and the tool raises without
one. The VAE is `--vae_path`'s native `vae/` dir, else the trainer's seeded
tiny VAE (`train.trainer.build_vae`, drawn on the device: the card's differs
from the CPU's). The text encoder is the trainer's (`build_text_encoder`):
T5 or a `transformers` model from `--text_encoder_path` (both need
`transformers` to tokenize), else the hermetic `ZeroTextEncoder`.

The posterior's draws for batch i come from a CPU `torch.Generator` keyed by
(`--seed`, i) and are moved to the device (`posterior_noise`), so a cache
built on the card equals one built on the CPU up to the convolutions'
rounding. They are not JAX's threefry draws: a seed gives other latents
than the JAX tool's.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

logger = logging.getLogger("f_lite_tpu_torch.precompute")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Write the precomputed training cache (VAE latents and "
                    "text embeddings) on an NVIDIA GPU")
    p.add_argument("--train_data_path", required=True)
    p.add_argument("--base_image_dir", default=None)
    p.add_argument("--image_column", default="media_path")
    p.add_argument("--caption_column", default="captions")
    p.add_argument("--root_dir_type", default="parquet")
    p.add_argument("--base_url", default="dummy://")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--vae_path", default=None)
    p.add_argument("--text_encoder_type", default="zero",
                   choices=["t5", "torch", "zero"])
    p.add_argument("--text_encoder_path", default=None)
    p.add_argument("--cross_attn_input_size", type=int, default=4096,
                   help="embedding dim for the zero/debug text encoder")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the encoders; 'cpu' runs them on "
                        "the CPU")
    return p.parse_args(argv)


def posterior_noise(seed: int, index: int, shape) -> torch.Tensor:
    """The standard normal draws of batch `index`'s posterior samples, from
    a CPU generator keyed by (seed, index): the same numbers on any
    device."""
    g = torch.Generator().manual_seed(seed * 1000003 + index)
    return torch.randn(tuple(shape), generator=g)


def encode_batch(vae, images: np.ndarray, device, *, seed: int = 0,
                 index: int = 0, noise=None) -> np.ndarray:
    """A batch's images (B, H, W, 3) in [-1, 1] -> normalized posterior
    samples (B, H/s, W/s, C), fp32 on the host: mean + std * noise, with
    `noise` a tensor (on any device) or, by default, `posterior_noise(seed,
    index, ...)`."""
    from f_lite_tpu_torch.models.vae import normalize_latents

    cfg = vae.config
    b, h, w, _ = images.shape
    if noise is None:
        noise = posterior_noise(seed, index, (b, h // cfg.spatial_scale,
                                              w // cfg.spatial_scale,
                                              cfg.latent_channels))
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device, torch.float32)
        z = vae.encode(x, noise=noise.to(device, torch.float32))
        return normalize_latents(z, cfg).cpu().numpy()


def main(argv=None) -> int:
    """Write the cache; the number of items written."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("precompute_embeddings: needs an NVIDIA GPU (pass "
                         "--device cpu to run on the CPU)")

    from f_lite_tpu_torch.data.dataset import ImageDataset
    from f_lite_tpu_torch.data.loader import DataLoader
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.train.trainer import build_text_encoder, build_vae

    # fp32 means fp32 on the card, as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = ImageDataset(
        args.train_data_path,
        base_image_dir=args.base_image_dir,
        image_column=args.image_column,
        caption_column=args.caption_column,
        resolution=args.resolution,
        center_crop=args.center_crop,
        root_dir_type=args.root_dir_type,
        base_url=args.base_url,
    )
    # the trainer's builders read these options of its own namespace
    build_args = argparse.Namespace(
        **vars(args), pixel_space=False, processor_path=None,
        use_precomputed_data=False, precomputed_data_dir=None)
    vae = build_vae(build_args, device)
    text_encoder = build_text_encoder(build_args, device)

    writer = PrecomputedCacheWriter(args.output_dir)
    loader = DataLoader(ds, batch_size=args.batch_size, num_workers=4)
    done = 0
    for index, batch in enumerate(loader):
        latents = encode_batch(vae, batch["image"], device, seed=args.seed,
                               index=index)
        embs, mask = text_encoder.encode(batch["caption"])
        for i in range(latents.shape[0]):
            n_real = int(mask[i].sum())
            writer.add(str(batch["_id"][i]), batch["caption"][i], latents[i],
                       embs[i, :n_real])
            done += 1
            if args.limit and done >= args.limit:
                break
        if args.limit and done >= args.limit:
            break
    writer.finalize()
    logger.info("wrote %d entries to %s", done, args.output_dir)
    return done


if __name__ == "__main__":
    main()
