"""The port's pipeline input and output against the JAX package, on the CPU:
the package surface, the safetensors writer, the inverse weight maps,
`save_pretrained`, `return_latents` and the trainer's VAE export.

- Writer: F32, BF16 and I8 tensors read back bit for bit by the
  `safetensors` package and by the port's reader.
- Inverse maps: port -> JAX -> port is bitwise for the DiT (fp32, bf16
  through a file, int8) and the VAE, and the int8 layout equals
  `quantize_dit_params`'s.
- `save_pretrained`: for the same weights the port's directory and the JAX
  package's (`scan_layers=False`) hold the same tensor names, shapes,
  dtypes and bits, in fp32, bf16 and int8, with equal `config.json`s and
  `model_index.json`; each package loads the other's directory and gives
  the same images (fp32, MSE < 1e-9).
- `return_latents=True`: `output_type="latent"` moved to the host, bit for
  bit, in the DiT's dtype; against JAX's `return_latents`, MSE < 1e-9 in
  fp32.
- The trainer (ROADMAP C 3): a latent-space run exports `vae/` (a seeded
  tiny VAE, or `--vae_path`'s); both packages load the export and decode
  the same latents within the fp32 VAE bar, 1e-5.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file

import f_lite_tpu
import f_lite_tpu_torch
from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu.quant import quantize_dit_params
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax, vae_state_dict_from_jax
from f_lite_tpu_torch.convert.to_jax import state_dict_to_jax, vae_state_dict_to_jax
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.quant import quantize_dit
from f_lite_tpu_torch.utils.random_weights import randomize_
from f_lite_tpu_torch.utils.safetensors import load_file, read_header, save_file
from test_torch_dit import flatten, random_jax_params, unflatten

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3, num_heads=4,
            mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
            train_bias_and_rms=True, cross_attn_first_n=1, cross_attn_period=2)
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


# ---------------------------------------------------------------------------
# the package surface (ROADMAP C 4)
# ---------------------------------------------------------------------------

def _names_served(pkg) -> set[str]:
    """`__all__` and every name the package's lazy `__getattr__` serves."""
    tree = ast.parse(Path(pkg.__file__).read_text())
    literals = {n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.isidentifier()}
    served = set()
    for name in literals:
        try:
            getattr(pkg, name)
        except AttributeError:
            continue
        served.add(name)
    return served | set(pkg.__all__)


def test_port_serves_every_name_the_jax_package_serves():
    names = _names_served(f_lite_tpu)
    assert {"APGConfig", "DiT", "DiTConfig", "FLitePipeline",
            "FLitePipelineOutput"} <= names
    for name in names:
        getattr(f_lite_tpu_torch, name)
    assert set(f_lite_tpu.__all__) <= set(f_lite_tpu_torch.__all__)
    assert "FLitePipelineOutput" in f_lite_tpu_torch.__all__
    out = f_lite_tpu_torch.FLitePipelineOutput(images=[1])
    assert out.images == [1]


# ---------------------------------------------------------------------------
# the safetensors writer
# ---------------------------------------------------------------------------

def test_writer_stores_f32_bf16_and_i8(tmp_path):
    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 5).astype(np.float32)
    bf16 = torch.from_numpy(rs.randn(4, 2).astype(np.float32)).to(torch.bfloat16)
    i8 = rs.randint(-127, 128, (6,)).astype(np.int8)
    path = tmp_path / "t.safetensors"
    save_file({"a": f32, "b": bf16, "c": torch.from_numpy(i8), "d": i8.copy()}, path)
    header, _ = read_header(path)
    assert {k: v["dtype"] for k, v in header.items()} == {
        "a": "F32", "b": "BF16", "c": "I8", "d": "I8"}
    theirs = st_load_file(str(path))
    np.testing.assert_array_equal(theirs["a"], f32)
    assert str(theirs["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(theirs["b"].view(np.uint16),
                                  bf16.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(theirs["c"], i8)
    ours = load_file(path)
    np.testing.assert_array_equal(ours["b"], bf16.float().numpy())
    np.testing.assert_array_equal(ours["d"], i8)
    with pytest.raises(ValueError, match="float64"):
        save_file({"x": np.zeros(2)}, tmp_path / "bad.safetensors")


# ---------------------------------------------------------------------------
# the inverse weight maps
# ---------------------------------------------------------------------------

def _port_dit(seed=0, **kw):
    return randomize_(DiT(DiTConfig(**{**TINY, **kw})), seed=seed).eval()


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(adaln_mode="per_block", cross_attn_all=True),
                                dict(use_rope=False, train_bias_and_rms=False)],
                         ids=["v1", "v2", "no_rope"])
def test_dit_round_trip_is_bitwise_in_fp32_and_int8(kw):
    model = _port_dit(**kw)
    cfg = model.config
    sd = model.state_dict()
    back = state_dict_from_jax({k: v.numpy() for k, v in state_dict_to_jax(sd, cfg).items()},
                               cfg)
    _assert_same(back, sd)

    quantize_dit(model)
    qsd = model.state_dict()
    flat = state_dict_to_jax(qsd, model.config)
    assert flat["blocks_0.self_attn.qkv.w8"].dtype == torch.int8
    assert flat["blocks_0.self_attn.qkv.w8"].shape == (64, 3, 4, 16)
    assert flat["blocks_0.self_attn.qkv.scale"].shape == (3, 4, 16)
    _assert_same(state_dict_from_jax({k: v.numpy() for k, v in flat.items()},
                                     model.config), qsd)


def test_int8_layout_equals_quantize_dit_params():
    flat = random_jax_params(JaxDiTConfig(**TINY), seed=3)
    cfg = DiTConfig(**TINY)
    model = DiT(cfg)
    model.load_state_dict(state_dict_from_jax(flat, cfg))
    quantize_dit(model)
    got = state_dict_to_jax(model.state_dict(), model.config)
    want = flatten(quantize_dit_params(unflatten(flat)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_bf16_dit_round_trips_through_a_file(tmp_path):
    model = _port_dit(seed=1).to(torch.bfloat16)
    sd = model.state_dict()
    save_file(state_dict_to_jax(sd, model.config), tmp_path / "p.safetensors")
    header, _ = read_header(tmp_path / "p.safetensors")
    assert {v["dtype"] for v in header.values()} == {"BF16"}
    back = state_dict_from_jax(load_file(tmp_path / "p.safetensors"), model.config)
    _assert_same({k: v.to(torch.bfloat16) for k, v in back.items()}, sd)


def test_vae_round_trip_is_bitwise_and_has_the_jax_keys():
    cfg = VAEConfig.tiny()
    vae = randomize_(AutoencoderKL(cfg), seed=2)
    flat = vae_state_dict_to_jax(vae.state_dict(), cfg)
    jparams = jvae.AutoencoderKL(jvae.VAEConfig.tiny()).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    want = flatten(jparams["params"])
    assert set(flat) == set(want)
    for k, v in want.items():
        assert tuple(flat[k].shape) == v.shape, k
    _assert_same(vae_state_dict_from_jax({k: v.numpy() for k, v in flat.items()}, cfg),
                 vae.state_dict())


# ---------------------------------------------------------------------------
# save_pretrained
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A latent-space pipeline (tiny DiT with biases on every projection,
    tiny VAE) saved by the JAX package, with seeded non-zero weights."""
    path = tmp_path_factory.mktemp("io_pipe")
    cfg = JaxDiTConfig(**TINY)
    params = {"params": unflatten(random_jax_params(cfg, seed=21))}
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    vparams = vae.init(jax.random.key(2), jnp.zeros((1, 8, 8, 3)))
    JaxPipeline(JaxDiT(cfg), params, vae, vparams).save_pretrained(path)
    return path


def _dir_tensors(path: Path) -> dict:
    out = {}
    for part in ("dit", "vae"):
        f = path / part / "flax_params.safetensors"
        if f.exists():
            out.update({f"{part}/{k}": v for k, v in st_load_file(str(f)).items()})
    return out


def _jsons(path: Path) -> dict:
    return {str(f.relative_to(path)): json.loads(f.read_text())
            for f in sorted(path.rglob("*.json"))}


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_save_pretrained_writes_what_the_jax_package_writes(tiny_dir, tmp_path, dtype,
                                                            quantize):
    tdtype, jdtype = DTYPES[dtype]
    FLitePipeline.from_pretrained(tiny_dir, dtype=tdtype, device="cpu",
                                  quantize=quantize).save_pretrained(tmp_path / "port")
    JaxPipeline.from_pretrained(tiny_dir, dtype=jdtype, load_text_encoder=False,
                                scan_layers=False, quantize=quantize,
                                ).save_pretrained(tmp_path / "jax")
    assert _jsons(tmp_path / "port") == _jsons(tmp_path / "jax")
    got, want = _dir_tensors(tmp_path / "port"), _dir_tensors(tmp_path / "jax")
    assert set(got) == set(want)
    assert any(k.endswith(".w8") for k in got) == quantize
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def _request(pipe, latents, **kw):
    rs = np.random.RandomState(9)
    embeds = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    return pipe(prompt_embeds=embeds, context_mask=mask, latents=latents,
                num_inference_steps=3, guidance_scale=4.0, **kw).images


def _images(pipe, latents):
    return np.asarray(_request(pipe, latents, output_type="np"))


def test_each_package_loads_the_others_directory(tiny_dir, tmp_path):
    FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                  device="cpu").save_pretrained(tmp_path / "port")
    JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32, load_text_encoder=False,
                                scan_layers=False).save_pretrained(tmp_path / "jax")
    latents = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    port_of_jax = _images(FLitePipeline.from_pretrained(
        tmp_path / "jax", dtype=torch.float32, device="cpu"), latents)
    jax_of_port = _images(JaxPipeline.from_pretrained(
        tmp_path / "port", dtype=jnp.float32, load_text_encoder=False),
        jnp.asarray(latents))
    assert port_of_jax.shape == (2, 16, 16, 3)
    mse = float(np.mean((port_of_jax - jax_of_port) ** 2))
    assert mse < 1e-9, mse


def test_quantized_directory_loads_only_with_quantize(tiny_dir, tmp_path):
    pipe = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32, device="cpu",
                                         quantize=True)
    pipe.save_pretrained(tmp_path / "q")
    with pytest.raises(ValueError, match="quantize=True"):
        FLitePipeline.from_pretrained(tmp_path / "q", device="cpu")
    again = FLitePipeline.from_pretrained(tmp_path / "q", dtype=torch.float32,
                                          device="cpu", quantize=True)
    _assert_same(again.dit.state_dict(), pipe.dit.state_dict())
    latents = np.random.RandomState(5).randn(2, 8, 8, 4).astype(np.float32)
    np.testing.assert_array_equal(_images(again, latents), _images(pipe, latents))
    jpipe = JaxPipeline.from_pretrained(tmp_path / "q", dtype=jnp.float32,
                                        load_text_encoder=False, quantize=True)
    assert jpipe.dit_model.config.quantized


# ---------------------------------------------------------------------------
# return_latents
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_return_latents_is_the_latent_output_on_the_host(tiny_dir, dtype):
    tdtype = DTYPES[dtype][0]
    pipe = FLitePipeline.from_pretrained(tiny_dir, dtype=tdtype, device="cpu")
    # no `latents=`: the start noise is drawn in the DiT's dtype (seed 0)
    size = dict(height=16, width=16)
    got = _request(pipe, None, return_latents=True, output_type="np", **size)
    want = _request(pipe, None, output_type="latent", **size)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == tdtype and tuple(got.shape) == (2, 8, 8, 4)
    torch.testing.assert_close(got, want.cpu(), atol=0, rtol=0)


def test_return_latents_matches_jax(tiny_dir):
    latents = np.random.RandomState(7).randn(2, 8, 8, 4).astype(np.float32)
    got = _request(FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                                 device="cpu"),
                   latents, return_latents=True).numpy()
    want = np.asarray(_request(JaxPipeline.from_pretrained(
        tiny_dir, dtype=jnp.float32, load_text_encoder=False),
        jnp.asarray(latents), return_latents=True))
    assert want.shape == got.shape == (2, 8, 8, 4)
    mse = float(np.mean((got - want) ** 2))
    assert mse < 1e-9, mse


# ---------------------------------------------------------------------------
# the trainer's export (ROADMAP C 3)
# ---------------------------------------------------------------------------

def _latent_cache(root: Path, n=8):
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter

    writer = PrecomputedCacheWriter(root)
    rs = np.random.RandomState(8)
    for i in range(n):
        writer.add(f"{i}", f"a caption {i % 3}",
                   rs.randn(8, 8, 16).astype(np.float32),
                   rs.randn(6 + i % 3, 32).astype(np.float32))
    writer.finalize()
    return root


def _train(cache, out, *extra):
    from f_lite_tpu_torch.train.trainer import parse_args, train

    train(parse_args([
        "--device", "cpu", "--use_precomputed_data", "--precomputed_data_dir",
        str(cache), "--model_width", "64", "--model_depth", "2",
        "--model_head_dim", "32", "--cross_attn_input_size", "32",
        "--train_batch_size", "4", "--max_steps", "2", "--log_every", "1",
        "--seed", "0", "--output_dir", str(out), "--export_pipeline", *extra]))
    return out / "pipeline"


def _decode_both(export):
    z = np.random.RandomState(10).randn(2, 8, 8, 16).astype(np.float32)
    jpipe = JaxPipeline.from_pretrained(export, dtype=jnp.float32,
                                        load_text_encoder=False)
    want = np.asarray(jpipe.vae.apply(jpipe.vae_params, jnp.asarray(z),
                                      method=jvae.AutoencoderKL.decode))
    tpipe = FLitePipeline.from_pretrained(export, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = tpipe.vae.decode(torch.from_numpy(z)).numpy()
    return got, want, tpipe


def test_latent_training_run_exports_its_vae(tmp_path):
    export = _train(_latent_cache(tmp_path / "cache"), tmp_path / "out")
    vcfg = json.loads((export / "vae" / "config.json").read_text())
    assert vcfg == VAEConfig.tiny(latent_channels=16).to_json_dict()
    got, want, tpipe = _decode_both(export)
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tpipe.vae_scale_factor == 2
    # the export's own latents decode through the VAE, not as an image
    out = tpipe(prompt_embeds=np.zeros((1, 4, 32), np.float32), height=16, width=16,
                num_inference_steps=1, output_type="np").images
    assert out.shape == (1, 16, 16, 3)

    # --vae_path: the given native vae/ goes into the export as it is
    again = _train(_latent_cache(tmp_path / "cache2"), tmp_path / "out2",
                   "--vae_path", str(export / "vae"))
    assert (_jsons(again / "vae") == _jsons(export / "vae"))
    a = st_load_file(str(again / "vae" / "flax_params.safetensors"))
    b = st_load_file(str(export / "vae" / "flax_params.safetensors"))
    assert set(a) == set(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_pixel_space_run_exports_no_vae(tmp_path):
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter

    writer = PrecomputedCacheWriter(tmp_path / "cache")
    rs = np.random.RandomState(9)
    for i in range(4):
        writer.add(f"{i}", "c", rs.uniform(-1, 1, (8, 8, 3)).astype(np.float32),
                   rs.randn(5, 32).astype(np.float32))
    writer.finalize()
    export = _train(tmp_path / "cache", tmp_path / "out", "--pixel_space")
    assert (export / "dit" / "flax_params.safetensors").exists()
    assert not (export / "vae").exists()
