from f_lite_tpu_torch.ops.guidance import (
    APGConfig,
    apg_combine,
    cfg_combine,
    guidance_combine,
)
from f_lite_tpu_torch.ops.norms import qk_norm, rms_norm
from f_lite_tpu_torch.ops.patching import patchify, unpatchify
from f_lite_tpu_torch.ops.rope import apply_rotary, rope_2d_freqs
from f_lite_tpu_torch.ops.timesteps import (
    euler_timestep_pairs,
    resolution_alpha,
    shift_t,
    timestep_embedding,
)

__all__ = [
    "APGConfig",
    "apg_combine",
    "cfg_combine",
    "guidance_combine",
    "qk_norm",
    "rms_norm",
    "patchify",
    "unpatchify",
    "apply_rotary",
    "rope_2d_freqs",
    "euler_timestep_pairs",
    "resolution_alpha",
    "shift_t",
    "timestep_embedding",
]
