"""The port's DiT against the JAX DiT, on the CPU in fp32.

Protocol of tests/test_parity.py: one parameter set (JAX `init_params`
shapes, every leaf replaced by seeded non-zero numpy values so the zero-init
heads do not hide anything) goes to JAX `DiT.apply` (XLA attention) and,
through `state_dict_from_jax`, to the port's `DiT`; the same numpy latents,
context, key mask and timesteps go to both. Bar: MSE < 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.convert.jax_to_torch import invert_dit_params
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.models.dit import DiT, DiTConfig

BASE = dict(in_channels=16, patch_size=2, hidden_size=64, depth=5,
            num_heads=4, mlp_ratio=2.0, cross_attn_input_size=48)

CONFIGS = {
    "v1_shared": {},
    "residual_v": dict(residual_v=True),
    "train_bias_and_rms": dict(train_bias_and_rms=True),
    "v2_per_block_cross_all": dict(adaln_mode="per_block", cross_attn_all=True),
    "dynamic_softmax_temperature": dict(dynamic_softmax_temperature=True),
    "no_rope_positional": dict(use_rope=False),
}


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def random_jax_params(cfg, seed):
    """JAX DiT params with every leaf seeded and non-zero: kernels
    N(0, (0.5/sqrt(fan_in))^2), RMSNorm weights 1 + N(0, 0.05^2), other
    vectors N(0, 0.05^2), registers/positions N(0, 1), lambda_v U(0, 1)."""
    shapes = flatten(JaxDiT(cfg).init_params(jax.random.key(0))["params"])
    rs = np.random.RandomState(seed)
    flat = {}
    for key, arr in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "lambda_v":
            val = rs.rand(*arr.shape)
        elif leaf == "kernel":
            val = rs.randn(*arr.shape) * 0.5 / np.sqrt(arr.shape[0])
        elif leaf == "weight":
            val = 1.0 + 0.05 * rs.randn(*arr.shape)
        elif leaf in ("register_tokens", "positional_embedding"):
            val = rs.randn(*arr.shape)
        else:
            val = 0.05 * rs.randn(*arr.shape)
        flat[key] = val.astype(np.float32)
        flat[key].flags.writeable = False  # shared through the cache
    return flat


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def port_dit(cfg_kw, flat):
    cfg = DiTConfig(**BASE, **cfg_kw)
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(flat, cfg), strict=True)
    return model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    cfg_kw = CONFIGS[name]
    jcfg = JaxDiTConfig(**BASE, **cfg_kw, use_pallas_attention=False)
    seed = list(CONFIGS).index(name)
    flat = random_jax_params(jcfg, seed)

    rs = np.random.RandomState(seed + 100)
    b, hw, s = 2, 16, 8
    x = rs.randn(b, hw, hw, jcfg.in_channels).astype(np.float32)
    ctx = rs.randn(b, s, jcfg.cross_attn_input_size).astype(np.float32)
    t = rs.rand(b).astype(np.float32)
    mask = np.arange(s)[None, :] < np.asarray([8, 5])[:, None]

    want = np.asarray(JaxDiT(jcfg).apply(
        {"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(ctx),
        jnp.asarray(mask), jnp.asarray(t),
    ))
    with torch.no_grad():
        got = port_dit(cfg_kw, flat)(
            torch.from_numpy(x), torch.from_numpy(ctx),
            torch.from_numpy(mask), torch.from_numpy(t),
        ).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 1e-2  # the heads are not zero
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-9, (mse, float(np.abs(got - want).max()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_keys_match_invert_dit_params(name):
    cfg_kw = CONFIGS[name]
    jcfg = JaxDiTConfig(**BASE, **cfg_kw, use_pallas_attention=False)
    flat = random_jax_params(jcfg, list(CONFIGS).index(name))
    sd = state_dict_from_jax(flat, DiTConfig(**BASE, **cfg_kw))
    ref = invert_dit_params({"params": unflatten(flat)}, jcfg)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # and they are exactly the port module's own keys and shapes
    own = port_dit(cfg_kw, flat).state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in sd.items()
    }


def test_config_json_refuses_unsupported_layouts():
    ok = dict(BASE, scan_layers=False, quantized=False, padded_heads=None,
              pipeline_stages=1, remat_policy="full")
    assert DiTConfig.from_json_dict(ok).hidden_size == 64
    # parameter layouts are undone at load; the port runs unrolled blocks
    for layout in (dict(scan_layers=True), dict(padded_heads=8),
                   dict(scan_layers=True, pipeline_stages=2)):
        assert DiTConfig.from_json_dict({**ok, **layout}) == DiTConfig(**BASE)
    # int8 serving is ported: `quantized` is read, not refused
    assert DiTConfig.from_json_dict({**ok, "quantized": True}).quantized
    with pytest.raises(ValueError, match="unknown fields"):
        DiTConfig.from_json_dict({**ok, "num_experts": 4})
    # head padding must be zeros: anything else is refused, not sliced off
    jcfg = JaxDiTConfig(**BASE, use_pallas_attention=False)
    flat = dict(random_jax_params(jcfg, 0))
    key = "blocks_1.self_attn.qkv.kernel"
    flat[key] = np.concatenate([flat[key], np.ones_like(flat[key][..., :1, :])], axis=-2)
    with pytest.raises(ValueError, match="padded heads"):
        state_dict_from_jax(flat, DiTConfig(**BASE))


@pytest.mark.parametrize(
    "name", ["v1_shared", "residual_v", "train_bias_and_rms",
             "v2_per_block_cross_all"])
def test_reference_state_dict_loads_strict_and_matches_oracle(name):
    """A state dict in the reference's own key layout
    (`make_random_state_dict`) loads with strict=True and the forward
    matches the functional torch oracle (MSE < 1e-9)."""
    from torch_oracle import make_random_state_dict, oracle_dit_forward

    cfg = DiTConfig(**BASE, **CONFIGS[name])
    sd = make_random_state_dict(cfg, seed=3)
    model = DiT(cfg).eval()
    model.load_state_dict(sd, strict=True)
    rs = np.random.RandomState(4)
    x = rs.randn(2, cfg.in_channels, 16, 16).astype(np.float32)
    ctx = rs.randn(2, 8, cfg.cross_attn_input_size).astype(np.float32)
    t = rs.rand(2).astype(np.float32)
    mask = torch.from_numpy(np.arange(8)[None, :] < np.array([[8], [5]]))
    want = oracle_dit_forward(sd, cfg, torch.from_numpy(x),
                              torch.from_numpy(ctx), mask,
                              torch.from_numpy(t)).numpy()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 2, 3, 1)),
                    torch.from_numpy(ctx), mask,
                    torch.from_numpy(t)).numpy().transpose(0, 3, 1, 2)
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-9, mse
