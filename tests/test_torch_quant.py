"""The port's int8 W8A8 serving (`f_lite_tpu_torch/quant.py`, `QuantDense`)
against the JAX package's (`f_lite_tpu/quant.py`), on the CPU.

Inputs come from numpy seeds and go to both. Bars:
- weights (w8, scale) and activations (x8, sx) bit-equal, int32
  accumulators equal;
- one projection's output within 1e-6 relative in fp32 and one bf16 ulp in
  bf16;
- a quantized DiT or pipeline: MSE(port, JAX int8) <= 1% of MSE(JAX int8,
  JAX fp32). The two int8 paths differ only where upstream fp32 rounding
  (attention's summation order) flips one x8 rounding; that must sit far
  under the quantization noise itself.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu import quant as jquant
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu_torch import quant
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.models.dit import DiT, DiTConfig, QuantDense
from f_lite_tpu_torch.ops.cuda import int8_gemm
from f_lite_tpu_torch.pipeline import FLitePipeline
from test_torch_dit import flatten, random_jax_params, unflatten

MSE_FRACTION = 0.01  # of the JAX int8 path's own quantization MSE

BASE = dict(in_channels=16, patch_size=2, hidden_size=64, depth=5,
            num_heads=4, mlp_ratio=2.0, cross_attn_input_size=48,
            residual_v=True, train_bias_and_rms=True)
DIT_CONFIGS = {
    "v1_shared": {},
    "v2_per_block": dict(adaln_mode="per_block", cross_attn_all=True),
}


def _jnp_dtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _jax_array(a, dtype):
    return jnp.asarray(a, _jnp_dtype(dtype))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["plain", "head_aligned"])
def test_quantize_weight_matches_quantize_kernel(layout, dtype):
    """w8 and scale bit-equal to `quantize_kernel`, from the weight as it is
    held (fp32 or bf16), for a plain (K, N) kernel and a head-aligned
    (K, 3, H, D) one after the converter's reordering; zero columns
    included."""
    rs = np.random.RandomState(0)
    k = 96
    shape = (k, 40) if layout == "plain" else (k, 3, 4, 8)
    kernel = (rs.randn(*shape) * 0.05).astype(np.float32)
    kernel[..., 3] = 0.0  # zero output columns: scale 1, w8 0
    jk = _jax_array(kernel, dtype)
    want = jquant.quantize_kernel(jk, 1 if layout == "plain" else 3)
    # the torch weight: (N, K), rows in the flattened output order
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jk.astype(jnp.float32)).reshape(k, -1).T)).to(dtype)
    w8, scale = quant.quantize_weight(w)
    assert w8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(
        w8.numpy(), np.asarray(want["w8"]).reshape(k, -1).T)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(want["scale"]).reshape(-1))
    assert (scale.numpy().reshape(-1, *shape[-1:])[..., 3] == 1.0).all()


def _jax_quant_steps(x, w8):
    """x8, sx and the int32 accumulators by `quant_matmul`'s own steps."""
    xf = x.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    sx = jnp.where(sx == 0, 1.0, sx)
    x8 = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x8, w8, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(x8), np.asarray(sx[:, 0]), np.asarray(acc)


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (2^(e - 7) for a in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quant_path_matches_quant_matmul(dtype, bias):
    rs = np.random.RandomState(1)
    m, k, n = 37, 160, 48
    x = (rs.randn(m, k) * 2.0).astype(np.float32)
    x[5] = 0.0  # a zero row: sx 1, x8 0
    x[7, :] = 0.5  # a row whose values land on the 127 boundary
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    b = (rs.randn(n) * 0.1).astype(np.float32)
    jx = _jax_array(x, dtype)
    jq = jquant.quantize_kernel(_jax_array(w, dtype))
    x8_want, sx_want, acc_want = _jax_quant_steps(jx, jq["w8"])
    y_want = jquant.quant_matmul(jx, jq["w8"], jq["scale"])
    if bias:  # QuantDense: y + bias.astype(y.dtype)
        y_want = y_want + _jax_array(b, dtype).astype(y_want.dtype)

    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(dtype)
    w8 = torch.from_numpy(np.ascontiguousarray(np.asarray(jq["w8"]).T))
    scale = torch.from_numpy(np.asarray(jq["scale"]))
    x8, sx = quant.quantize_rows_plain(tx)
    np.testing.assert_array_equal(x8.numpy(), x8_want)
    np.testing.assert_array_equal(sx.numpy(), sx_want)
    np.testing.assert_array_equal(int8_gemm.int8_matmul_plain(x8, w8).numpy(),
                                  acc_want)
    tb = torch.from_numpy(b).to(dtype) if bias else None
    y = quant.quant_matmul(tx, w8, scale, tb)
    assert y.dtype == dtype and y.shape == (m, n)
    got, want = _np(y), _np(y_want)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("case", ["zero_weight_columns", "zero_activation_rows"])
def test_zero_columns_and_rows(case):
    """All-zero weight columns give exact zeros (scale 1, w8 0); all-zero
    activation rows give exact zeros (sx 1, x8 0); both finite, as JAX's."""
    rs = np.random.RandomState(2)
    if case == "zero_weight_columns":
        w, x = np.zeros((32, 16), np.float32), rs.randn(4, 32).astype(np.float32)
    else:
        w, x = rs.randn(32, 16).astype(np.float32), np.zeros((4, 32), np.float32)
    jq = jquant.quantize_kernel(jnp.asarray(w))
    want = np.asarray(jquant.quant_matmul(jnp.asarray(x), jq["w8"], jq["scale"]))
    w8, scale = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = quant.quant_matmul(torch.from_numpy(x), w8, scale).numpy()
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)


def _dit_inputs(cfg, seed):
    rs = np.random.RandomState(seed)
    b, hw, s = 2, 16, 8
    return (rs.randn(b, hw, hw, cfg.in_channels).astype(np.float32),
            rs.randn(b, s, cfg.cross_attn_input_size).astype(np.float32),
            np.arange(s)[None, :] < np.asarray([8, 5])[:, None],
            rs.rand(b).astype(np.float32))


def _jax_quantized(name):
    """(JAX config, float params, quantized params) of a tiny DiT."""
    jcfg = JaxDiTConfig(**BASE, **DIT_CONFIGS[name], use_pallas_attention=False)
    flat = random_jax_params(jcfg, list(DIT_CONFIGS).index(name) + 20)
    params = {"params": unflatten(flat)}
    return jcfg, params, jquant.quantize_dit_params(params)


@pytest.mark.parametrize("name", list(DIT_CONFIGS))
def test_quantized_dit_matches_jax(name):
    jcfg, params, qparams = _jax_quantized(name)
    args = _dit_inputs(jcfg, 30)
    jargs = tuple(map(jnp.asarray, args))
    ref = np.asarray(JaxDiT(jcfg).apply(params, *jargs))
    qcfg = dataclasses.replace(jcfg, quantized=True)
    want = np.asarray(JaxDiT(qcfg).apply(qparams, *jargs))

    cfg = DiTConfig(**BASE, **DIT_CONFIGS[name], quantized=True)
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(flatten(qparams["params"]), cfg),
                          strict=True)
    n_quant = sum(isinstance(m, QuantDense) for m in model.modules())
    n_cross = sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))
    assert n_quant == 5 * cfg.depth + 3 * n_cross
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    noise = float(((want - ref) ** 2).mean())
    diff = float(((got - want) ** 2).mean())
    assert noise > 0
    assert diff <= MSE_FRACTION * noise, (diff, noise)

    # the port's own quantize_dit of the float weights gives the same int8
    # weights as the JAX tree it was fed
    float_model = DiT(dataclasses.replace(cfg, quantized=False))
    float_model.load_state_dict(
        state_dict_from_jax(flatten(params["params"]), cfg))
    quant.quantize_dit(float_model)
    assert float_model.config.quantized
    for key, t in model.state_dict().items():
        torch.testing.assert_close(float_model.state_dict()[key], t, atol=0,
                                   rtol=0, msg=lambda m, k=key: f"{k}: {m}")


def test_scan_stacked_quantized_tree_converts():
    """A scan-stacked quantized JAX tree (leading layers axis on w8 and
    scale) converts to the same state dict as the unrolled one."""
    from f_lite_tpu.convert.torch_to_jax import to_scan_layout

    jcfg, params, qparams = _jax_quantized("v1_shared")
    scfg = dataclasses.replace(jcfg, scan_layers=True)
    stacked = jquant.quantize_dit_params(
        {"params": to_scan_layout(params["params"], scfg)})
    cfg = DiTConfig(**BASE, quantized=True)
    want = state_dict_from_jax(flatten(qparams["params"]), cfg)
    got = state_dict_from_jax(flatten(stacked["params"]), cfg)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


def test_dequantize_dit_matches_dequantize_dit_params():
    _, _, qparams = _jax_quantized("v1_shared")
    cfg = DiTConfig(**BASE, quantized=True)
    model = DiT(cfg)
    model.load_state_dict(state_dict_from_jax(flatten(qparams["params"]), cfg))
    quant.dequantize_dit(model, torch.float32)
    assert not model.config.quantized
    assert not any(isinstance(m, QuantDense) for m in model.modules())
    deq = jquant.dequantize_dit_params(qparams, jnp.float32)
    want = state_dict_from_jax(flatten(deq["params"]),
                               dataclasses.replace(cfg, quantized=False))
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=1e-6, rtol=1e-6)


def test_config_json_accepts_quantized():
    d = DiTConfig(**BASE).to_json_dict()
    assert d["quantized"] is False
    cfg = DiTConfig.from_json_dict({**d, "quantized": True})
    assert cfg.quantized and cfg.to_json_dict()["quantized"] is True
    assert isinstance(DiT(cfg).blocks[0].mlp.up_proj, QuantDense)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A pixel-space pipeline (tiny DiT, no VAE) saved by the JAX package,
    with seeded non-zero weights and biases on the quantized layers."""
    path = tmp_path_factory.mktemp("tiny_quant_pipe")
    cfg = JaxDiTConfig(in_channels=4, patch_size=2, hidden_size=64, depth=3,
                       num_heads=4, mlp_ratio=2.0, cross_attn_input_size=32,
                       residual_v=True, train_bias_and_rms=True,
                       cross_attn_first_n=1, cross_attn_period=2)
    params = {"params": unflatten(random_jax_params(cfg, seed=12))}
    JaxPipeline(JaxDiT(cfg), params).save_pretrained(path)
    return path


def test_from_pretrained_quantize_matches_jax(tiny_dir):
    rs = np.random.RandomState(7)
    embeds = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    latents = rs.randn(2, 16, 16, 4).astype(np.float32)
    kw = dict(prompt_embeds=embeds, context_mask=mask, num_inference_steps=2,
              guidance_scale=4.0, output_type="np")
    jax_images = {}
    for q in (False, True):
        jpipe = JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32,
                                            load_text_encoder=False,
                                            quantize=q)
        jax_images[q] = np.asarray(jpipe(**kw, latents=jnp.asarray(latents)).images)
    pipe = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                         device="cpu", quantize=True)
    assert pipe.dit.config.quantized
    got = pipe(**kw, latents=latents).images
    plain = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                          device="cpu")(**kw, latents=latents).images
    assert got.shape == jax_images[True].shape == (2, 16, 16, 4)
    noise = float(((jax_images[True] - jax_images[False]) ** 2).mean())
    diff = float(((got - jax_images[True]) ** 2).mean())
    assert noise > 0
    assert diff <= MSE_FRACTION * noise, (diff, noise)
    assert np.corrcoef(got.ravel(), plain.ravel())[0, 1] > 0.99


def test_from_pretrained_refuses_int8_weights_without_quantize(tmp_path, tiny_dir):
    """A pipeline saved with int8 weights loads with quantize=True only."""
    import shutil

    from f_lite_tpu.pipeline import (
        load_params_safetensors,
        save_params_safetensors,
    )

    shutil.copytree(tiny_dir, tmp_path / "p")
    st = tmp_path / "p" / "dit" / "flax_params.safetensors"
    save_params_safetensors(jquant.quantize_dit_params(load_params_safetensors(st)), st)
    with pytest.raises(ValueError, match="quantize=True"):
        FLitePipeline.from_pretrained(tmp_path / "p", device="cpu")
    pipe = FLitePipeline.from_pretrained(tmp_path / "p", dtype=torch.float32,
                                         device="cpu", quantize=True)
    want = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                         device="cpu", quantize=True)
    for key, t in want.dit.state_dict().items():
        torch.testing.assert_close(pipe.dit.state_dict()[key], t, atol=0, rtol=0)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(5, 32).astype(np.float32))
    w8 = torch.from_numpy(rs.randint(-127, 128, (16, 32)).astype(np.int8))
    scale = torch.from_numpy(rs.rand(16).astype(np.float32))
    before = (int8_gemm.QUANTIZE_LAUNCHES.count, int8_gemm.GEMM_LAUNCHES.count)
    x8, sx = int8_gemm.quantize_rows(x)
    y = int8_gemm.int8_gemm_dequant(x8, sx, w8, scale, out_dtype=torch.float32)
    acc = int8_gemm.int8_gemm_int32(x8, w8)
    assert (int8_gemm.QUANTIZE_LAUNCHES.count, int8_gemm.GEMM_LAUNCHES.count) == before
    torch.testing.assert_close(
        y, int8_gemm.int8_linear_plain(x8, sx, w8, scale, None, torch.float32),
        atol=0, rtol=0)
    assert acc.dtype == torch.int32
    torch.testing.assert_close(y, (acc.float() * sx[:, None]) * scale, atol=0, rtol=0)


def test_from_pretrained_quantize_defaults_to_the_card(tiny_dir):
    """quantize=True keeps the card as the default device: without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLitePipeline.from_pretrained(tiny_dir, quantize=True)


def test_quant_dense_keeps_fp32_scales_through_a_cast():
    """`.to(bfloat16)` casts a QuantDense's bias, never its fp32 scales or
    its int8 weights."""
    w8 = torch.from_numpy(np.random.RandomState(4).randint(-127, 128, (16, 32)).astype(np.int8))
    scale = torch.linspace(1e-3, 2e-3, 16)  # not representable in bf16
    layer = QuantDense.from_quantized(w8, scale.clone(), torch.nn.Parameter(torch.ones(16)))
    layer.to(torch.bfloat16)
    assert layer.bias.dtype == torch.bfloat16
    assert layer.w8.dtype == torch.int8 and torch.equal(layer.w8, w8)
    assert layer.scale.dtype == torch.float32 and torch.equal(layer.scale, scale)


def test_int8_dit_turns_tiny_input_changes_into_rounding_flips():
    """Why a card run of the int8 path is held to the quantization noise and
    not to 1% of it: on the CPU alone, scaling the fixture DiT's input by
    1 + 1e-7 noise moves the fp32 output by an MSE near 6e-14 but the int8
    output by about 40% of its own quantization noise (1.1e-6 against
    2.6e-6). Each upstream change flips some x8 roundings by one step, and
    the flips compound through the blocks."""
    from pathlib import Path

    fixture = Path(__file__).resolve().parent.parent / "artifacts" / "fixture_run" / "pipeline"
    dits = {q: FLitePipeline.from_pretrained(fixture, dtype=torch.float32,
                                             device="cpu", quantize=q).dit
            for q in (False, True)}
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32))
    rest = (torch.from_numpy(rs.randn(2, 32, 64).astype(np.float32) * 0.02),
            torch.from_numpy(np.arange(32)[None] < np.array([[32], [9]])),
            torch.from_numpy(rs.rand(2).astype(np.float32)))
    moved_x = x * (1 + 1e-7 * torch.from_numpy(rs.randn(*x.shape).astype(np.float32)))
    with torch.no_grad():
        out = {q: (d(x, *rest), d(moved_x, *rest)) for q, d in dits.items()}
    noise = float(((out[True][0] - out[False][0]) ** 2).mean())
    moved = {q: float(((a - b) ** 2).mean()) for q, (a, b) in out.items()}
    print(f"int8 moved {moved[True]}, fp32 moved {moved[False]}, noise {noise}")
    assert moved[False] < 1e-12
    assert moved[True] > 0.1 * noise


# ---------------------------------------------------------------------------
# the persistent product kernel's tile order (`int8_gemm.tile_schedule`)
# ---------------------------------------------------------------------------

def _assert_schedule_covers_the_grid(m, n, num_sms, block_n):
    """Every (m-tile, n-tile) exactly once and nothing outside the grid; no
    more blocks than SMs or tiles; the blocks' tile counts differ by at
    most one."""
    tiles_m, tiles_n = -(-m // 128), -(-n // block_n)
    schedule = int8_gemm.tile_schedule(m, n, num_sms, block_n)
    assert len(schedule) == min(num_sms, tiles_m * tiles_n)
    assert sorted(t for block in schedule for t in block) == [
        (i, j) for i in range(tiles_m) for j in range(tiles_n)]
    counts = [len(block) for block in schedule]
    assert max(counts) - min(counts) <= 1
    if num_sms >= tiles_m * tiles_n:
        assert max(counts) == 1  # fewer tiles than SMs: one each


# (M, N, SMs): the grid's edges on 132 SMs at one n-tile of either width,
# fewer tiles than SMs, the fixture's widest, one SM, one row and column
SCHEDULE_CASES = [
    (128 * 131, 128, 132), (128 * 131, 256, 132),       # SMs - 1 tiles
    (128 * 132 - 5, 128, 132), (128 * 132 - 5, 256, 132),  # SMs, ragged rows
    (128 * 132 + 1, 128, 132), (128 * 132 + 1, 256, 132),  # SMs + 1
    (128 * 176 - 64, 256, 132),                         # a partial last round
    (1000, 1024, 132), (49920, 10240, 132), (50000, 10240, 131),
    (8224, 7680, 1), (1, 8, 132), (1, 10240, 7), (50000, 8, 2),
]


@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("m,n,num_sms", SCHEDULE_CASES)
def test_tile_schedule_covers_every_tile_once(block_n, m, n, num_sms):
    _assert_schedule_covers_the_grid(m, n, num_sms, block_n)


@pytest.mark.parametrize("block_n", [128, 256])
def test_tile_schedule_covers_every_tile_once_over_a_seeded_sweep(block_n):
    """200 seeded draws of M in 1-50000, N a multiple of 8 up to 10240 and
    1-132 SMs."""
    rs = np.random.RandomState(block_n)
    for m, n8, num_sms in zip(rs.randint(1, 50001, 200), rs.randint(1, 1281, 200),
                              rs.randint(1, 133, 200)):
        _assert_schedule_covers_the_grid(int(m), 8 * int(n8), int(num_sms), block_n)


@pytest.mark.parametrize("tiles_m,tiles_n,group_m", [
    (65, 30, 8), (391, 4, 8), (2, 20, 8), (13, 7, 4), (9, 1, 8), (33, 30, 4)])
def test_tile_order_walks_groups_of_m_tiles(tiles_m, tiles_n, group_m):
    """Inside a group the m-tiles vary fastest over the group's rows and
    the n-tile stays; groups follow each other; the last may be short."""
    order = [int8_gemm.tile_coords(t, tiles_m, tiles_n, group_m)
             for t in range(tiles_m * tiles_n)]
    t = 0
    for first in range(0, tiles_m, group_m):
        size = min(group_m, tiles_m - first)
        for nt in range(tiles_n):
            assert order[t:t + size] == [(first + i, nt) for i in range(size)]
            t += size
    assert t == len(order)


def test_tile_schedule_matches_the_kernel_defaults():
    """BLOCK_M, GROUP_M and each design's BLOCK_N are the kernel's kBM,
    kGroupM and `Design<PingPong>::kBN`, and the designs' codes those of
    its C entry."""
    src = (Path(int8_gemm.__file__).resolve().parents[2] / "csrc" / "int8_gemm.cu").read_text()
    assert f"constexpr int kBM = {int8_gemm.BLOCK_M};" in src
    assert f"constexpr int kGroupM = {int8_gemm.GROUP_M};" in src
    kbn = re.search(r"kBN = PingPong \? (\d+) : (\d+);", src).groups()
    assert tuple(map(int, kbn)) == (int8_gemm.BLOCK_N[int8_gemm.PINGPONG],
                                    int8_gemm.BLOCK_N[int8_gemm.COOPERATIVE])
    assert f"if (design == {int8_gemm.PINGPONG})\n    return launch_gemm_typed<true>" in src
    assert f"if (design == {int8_gemm.COOPERATIVE})\n    return launch_gemm_typed<false>" in src


@pytest.mark.parametrize("k,design", [
    (16, "PINGPONG"), (2560, "PINGPONG"), (4080, "PINGPONG"),
    (4096, "COOPERATIVE"), (10240, "COOPERATIVE")])
def test_gemm_design_switches_at_cooperative_min_k(k, design):
    assert int8_gemm.COOPERATIVE_MIN_K == 4096
    assert int8_gemm.gemm_design(k) == getattr(int8_gemm, design)


def test_edge_shapes_meet_the_grid_edges():
    """`int8_tiles.edge_shapes` gives, at each K, one n-tile of the design
    the wrapper picks and SMs - 1, SMs, SMs + 1 tiles and a partial last
    round."""
    from f_lite_tpu_torch.tools.int8_tiles import EDGE_K, edge_shapes

    shapes = edge_shapes(132)
    assert len(shapes) == 4 * len(EDGE_K)
    assert {int8_gemm.gemm_design(k) for k in EDGE_K} == {
        int8_gemm.PINGPONG, int8_gemm.COOPERATIVE}
    for i, (_, m, n, k) in enumerate(shapes):
        assert k % 128 == 16 and n == int8_gemm.BLOCK_N[int8_gemm.gemm_design(k)]
        schedule = int8_gemm.tile_schedule(m, n, 132, n)
        tiles = sum(map(len, schedule))
        assert tiles == (131, 132, 133, 176)[i % 4]
        assert len(schedule) == min(tiles, 132)


@pytest.mark.parametrize("a,b,block_n", [(11.6, 0.71, 256), (2.0, 0.6, 256),
                                         (0.5, 0.9, 128)])
def test_k_sweep_fit_recovers_the_costs(a, b, block_n):
    """`fit_k_sweep` returns the fixed cost a tile and the cost a k-tile
    of times made from them, in the kernel's own tiles (15 waves of 128 x
    256 tiles or 30 of 128 x 128 at M 8224, N 7680 on 132 SMs), with no
    residual."""
    from f_lite_tpu_torch.tools.int8_tiles import K_SWEEP, fit_k_sweep

    waves = 15 if block_n == 256 else 30
    points = [(k, waves * (a + b * -(-k // 128)) / 1e3) for k in K_SWEEP]
    fit = fit_k_sweep(points, 8224, 7680, 132, block_n)
    assert fit["waves"] == waves and fit["tile"] == f"128x{block_n}"
    assert abs(fit["fixed_us_per_tile"] - a) < 1e-9
    assert abs(fit["us_per_k_tile"] - b) < 1e-9
    assert fit["max_rel_residual"] < 1e-9 and fit["max_abs_residual_us"] < 1e-9
    assert fit["fixed_cost_resolved"]


def test_k_sweep_fit_flags_an_unresolved_fixed_cost():
    """A fixed cost smaller than the points' scatter about the line is
    reported as not resolved."""
    from f_lite_tpu_torch.tools.int8_tiles import fit_k_sweep

    ks, noise = (1024, 2560, 4096, 10240), (1.0, -1.0, 1.0, -1.0)
    points = [(k, 30 * (0.2 + 0.8 * (k // 128) + e) / 1e3) for k, e in zip(ks, noise)]
    fit = fit_k_sweep(points, 8224, 7680, 132, 128)
    assert fit["max_abs_residual_us"] > abs(fit["fixed_us_per_tile"])
    assert not fit["fixed_cost_resolved"]
