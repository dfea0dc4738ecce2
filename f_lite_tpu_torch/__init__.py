"""f-lite-tpu-torch: the PyTorch/CUDA port of `f_lite_tpu` for NVIDIA Hopper.

Mirrors the JAX package's layout (`ops/`, `models/`, `sampling/`, `text/`,
`convert/`, `pipeline.py`) and imports neither JAX nor `f_lite_tpu`. Entry
points run on the card (`device="cuda"`) unless the caller asks for the
CPU; the one Pallas kernel of the serving path, the flash-attention
forward, is a hand-written CUDA kernel (`csrc/flash_attention_fwd.cu`).
"""

__version__ = "0.1.0"

__all__ = ["APGConfig", "DiT", "DiTConfig", "FLitePipeline"]


def __getattr__(name):
    # lazy, so `import f_lite_tpu_torch` stays cheap
    if name == "APGConfig":
        from f_lite_tpu_torch.ops.guidance import APGConfig

        return APGConfig
    if name in ("DiT", "DiTConfig"):
        from f_lite_tpu_torch.models import dit

        return getattr(dit, name)
    if name == "FLitePipeline":
        from f_lite_tpu_torch.pipeline import FLitePipeline

        return FLitePipeline
    raise AttributeError(name)
