"""The port's perf-lab forward variants (`ops/cuda/flash_variants.py`)
against the TPU kernel of `tools/flash_variants.py`, run as a Pallas
interpreter on the CPU (`force_tpu_interpret_mode`, blocks 128/128).

On the CPU the port's wrapper computes `flash_fwd_plain`, which rounds
where the source rounds: the exp argument and p to bf16, q * scale (*
log2 e) to q's dtype outside the kernel, alpha's argument and result to
bf16 under `alpha_bf16`. Bars:
- base, prescale, condmask-e: 1e-6 in fp32, 1e-3 in bf16 (one bf16 ulp of
  the output at its largest values);
- the exp2 and alpha_bf16 rows: 10% of the output's rms. Two lowerings of
  XLA on the CPU, not of the TPU, set this bar: bf16 `exp2` becomes
  exp(bf16(x * bf16(ln 2))), off by an ulp or more for most bf16 values
  and by up to 12% for one term; and `exp(bf16).astype(f32)` is folded, so
  the interpreter never rounds alpha's result. The port computes what the
  source states (fp32 exp2 / exp of the bf16-rounded argument, rounded to
  bf16), as the TPU does.
The Hopper kernel is held to `flash_fwd_plain` on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from f_lite_tpu_torch.ops.cuda import flash_attention as tfa
from f_lite_tpu_torch.ops.cuda import flash_variants as tfv

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools import flash_variants as jfv  # noqa: E402

EXACT = ("base", "prescale", "condmask-e")
SHAPES = {"fp32_d64": ((1, 2, 200, 64), torch.float32, jnp.float32),
          "bf16_d256": ((1, 1, 300, 256), torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module", params=list(SHAPES))
def outputs(request):
    """Every variant through the interpreter and through the port."""
    shape, tdtype, jdtype = SHAPES[request.param]
    arrs = _inputs(shape)
    jq, jk, jv = (jnp.asarray(a).astype(jdtype) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in arrs)
    res = {}
    for name, kw in tfv.VARIANTS.items():
        with pltpu.force_tpu_interpret_mode():
            want = jfv.flash_fwd(jq, jk, jv, block_q=128, block_k=128, **kw)
        tfv.LAUNCHES.reset()
        got = tfv.flash_fwd(tq, tk, tv, block_q=64, block_k=128, **kw)
        assert tfv.LAUNCHES.count == 0  # CPU tensors never launch the kernel
        assert got.dtype == tdtype and got.shape == shape
        res[name] = (np.asarray(want.astype(jnp.float32)), got.float().numpy())
    return request.param, res


@pytest.mark.parametrize("variant", list(tfv.VARIANTS))
def test_variant_matches_the_tpu_kernel(outputs, variant):
    shape_name, res = outputs
    want, got = res[variant]
    if variant in EXACT:
        bar = 1e-6 if shape_name.startswith("fp32") else 1e-3
    else:
        bar = 0.1 * float(np.sqrt((want**2).mean()))
    err = float(np.abs(got - want).max())
    assert err <= bar, (variant, err, bar)


def test_condmask_equals_its_twin(outputs):
    _, res = outputs
    np.testing.assert_array_equal(res["condmask-e"][1], res["base"][1])
    np.testing.assert_array_equal(res["condmask"][1], res["exp2"][1])


def _bf16(x):
    return x.astype(np.float32).astype(jnp.bfloat16).astype(np.float64)


def _reference_f64(q, k, v, block_k, use_exp2=False, alpha_bf16=False):
    """The source's arithmetic in float64 with its bf16 rounding points
    (numpy, independent of the port's code): q prescaled and rounded to
    fp32 under exp2, the exp argument and p rounded to bf16, alpha rounded
    twice under alpha_bf16."""
    d = q.shape[-1]
    scale = d**-0.5
    exp = np.exp2 if use_exp2 else np.exp
    if use_exp2:
        q = (q * np.float32(scale * tfv.LOG2E)).astype(np.float32)
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    m = np.full(q.shape[:-1] + (1,), tfv.NEG_INF)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape)
    for k0 in range(0, k.shape[2], block_k):
        s = q @ np.swapaxes(k[:, :, k0:k0 + block_k], -1, -2)
        if not use_exp2:
            s = s * scale
        m_next = np.maximum(m, s.max(-1, keepdims=True))
        p = _bf16(exp(_bf16(s - m_next)))
        alpha = _bf16(exp(_bf16(m - m_next))) if alpha_bf16 else exp(m - m_next)
        l = p.sum(-1, keepdims=True) + alpha * l
        acc = acc * alpha + p @ v[:, :, k0:k0 + block_k]
        m = m_next
    return acc / l


@pytest.mark.parametrize("kw", [dict(), dict(use_exp2=True),
                                dict(alpha_bf16=True, prescale=True)])
def test_plain_rounds_where_the_source_says(kw):
    """fp32 `flash_fwd_plain` against the float64 reference with the same
    rounding points (1e-6), and the same reference without them lands
    farther away: the rounding is real, not lost in fp32 noise."""
    q, k, v = _inputs((1, 2, 100, 64), seed=3)
    got = tfv.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), block_k=64,
                              **kw).numpy()
    ref = _reference_f64(q, k, v, 64, use_exp2=kw.get("use_exp2", False),
                         alpha_bf16=kw.get("alpha_bf16", False))
    assert float(np.abs(got - ref).max()) < 1e-6
    logits = q.astype(np.float64) @ np.swapaxes(k, -1, -2) * 64**-0.5
    p = np.exp(logits - logits.max(-1, keepdims=True))
    exact = (p / p.sum(-1, keepdims=True)) @ v
    assert float(np.abs(got - exact).max()) > 1e-4


def test_result_depends_on_block_k_only():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs((1, 2, 150, 64), seed=4))
    a = tfv.flash_fwd(q, k, v, block_q=64, block_k=64)
    b = tfv.flash_fwd(q, k, v, block_q=128, block_k=64)
    c = tfv.flash_fwd(q, k, v, block_q=64, block_k=128)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("block_k", [64, 128])
def test_flag_step_tells_a_flag_branch_from_none(d, block_k):
    """`flag_step`, which the card checks use on the kernel: the plain
    result of a variant, rounded to the kernel's bf16 output, lies at the
    full step from its twin (1); its twin's, as a kernel whose flag branch
    did nothing would give, at none (0). Both within FLAG_STEP_TOLERANCE,
    at the ragged shape, though the twins differ by less than the
    kernel-against-plain tolerance."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs((1, 2, 333, d), seed=7))
    plain = {name: tfv.flash_fwd_plain(q, k, v, block_k=block_k,
                                       out_dtype=torch.float32, **kw)
             for name, kw in tfv.VARIANTS.items()}
    for own, twin in tfv.FLAG_TWINS:
        a, b = plain[own], plain[twin]
        assert float((a - b).abs().max()) < tfa.tolerance(a, torch.bfloat16)
        assert abs(tfv.flag_step(a.bfloat16(), a, b) - 1) < tfv.FLAG_STEP_TOLERANCE
        assert abs(tfv.flag_step(b.bfloat16(), a, b)) < tfv.FLAG_STEP_TOLERANCE
    with pytest.raises(ValueError, match="equal"):
        tfv.flag_step(plain["base"], plain["condmask-e"], plain["base"])


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"))
    assert tfv.COMPILED_FLAGS == {0, 1, 3, 7, 4, 9, 15}


PADDED_DIMS = [32, 96, 128, 192]


@pytest.fixture(scope="module")
def d96_outputs():
    """The exact variants at D = 96 through the interpreter (which pads D
    to 128 lanes) and through the port (plain at the true D), fp32."""
    arrs = _inputs((1, 2, 150, 96), seed=11)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    res = {}
    for name in EXACT:
        kw = tfv.VARIANTS[name]
        with pltpu.force_tpu_interpret_mode():
            want = jfv.flash_fwd(jq, jk, jv, block_q=128, block_k=128, **kw)
        got = tfv.flash_fwd(tq, tk, tv, block_k=128, **kw)
        res[name] = (np.asarray(want), got.numpy())
    return res


@pytest.mark.parametrize("variant", EXACT)
def test_padded_head_dim_matches_the_tpu_kernel(d96_outputs, variant):
    """At a head dim with no compiled instance (96: the TPU lab pads it to
    128 lanes, the card's wrapper to 256) the port's lab gives the TPU
    kernel's numbers at the true D's scale, 1e-6 in fp32."""
    want, got = d96_outputs[variant]
    assert want.shape == got.shape == (1, 2, 150, 96)
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.parametrize("d", PADDED_DIMS)
def test_zero_padding_along_d_leaves_the_variants_unchanged(d):
    """What the card's wrapper does at such a D: q, k and v zero-padded
    along D to `padded_head_dim(d)`, the computation at the padded D with
    the true D's scale, the output sliced back. fp32, every variant, against
    `flash_fwd_plain` at the true D (1e-6); the padded columns come out
    zero. The wrapper prescales q before padding it, which is the same as
    prescaling the padded q (zeros stay zeros)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 70, d), seed=12))
    scale = d**-0.5
    qp, kp, vp = (tfa.pad_head_dim(x) for x in (q, k, v))
    assert qp.shape[-1] == tfa.padded_head_dim(d) > d
    for use_exp2 in (False, True):
        assert torch.equal(tfa.pad_head_dim(tfv.prescale_q(q, scale, use_exp2)),
                           tfv.prescale_q(qp, scale, use_exp2))
    for name, kw in tfv.VARIANTS.items():
        want = tfv.flash_fwd_plain(q, k, v, block_k=32, **kw)
        got = tfv.flash_fwd_plain(qp, kp, vp, scale=scale, block_k=32, **kw)
        torch.testing.assert_close(got[..., :d], want, atol=1e-6, rtol=0,
                                   msg=name)
        assert not got[..., d:].any(), name


def test_blocks_by_head_dim():
    """`blocks(d)`: the pairs of the compiled head dim `d` is padded to, 128
    query rows each, the serving forward's pair (the default tile of
    csrc/flash_attention_fwd.cu) among them; D > 256 raises.
    Each pair is what the kernel's source compiles for that head dim
    (`launch_blocks<D, BK...>` in csrc/flash_attention_variants.cu), and
    each BK has a wgmma instance in csrc/hopper.cuh."""
    import re

    from f_lite_tpu_torch.ops.cuda import build

    for d in range(1, 257):
        assert tfv.blocks(d) == tfv.BLOCKS[64 if d <= 64 else 256], d
    with pytest.raises(ValueError, match="head dim"):
        tfv.blocks(257)
    hopper = (build.CSRC / "hopper.cuh").read_text()
    src = (build.CSRC / "flash_attention_variants.cu").read_text()
    compiled = {int(d): [int(x) for x in bks.split(",")]
                for d, bks in re.findall(r"launch_blocks<(\d+), ([\d, ]+)>", src)}
    assert compiled == {d: [bk for _, bk in pairs] for d, pairs in tfv.BLOCKS.items()}
    assert "flash_attention_variants" in build.SOURCES
    fwd = (build.CSRC / "flash_attention_fwd.cu").read_text()
    for d, pairs in tfv.BLOCKS.items():
        assert all(bq == 128 for bq, _ in pairs) and len(set(pairs)) == 3
        assert tfv.SERVING_BLOCKS[d] in pairs
        assert f"#define FLASH_FWD_BK_D{d} {tfv.SERVING_BLOCKS[d][1]}\n" in fwd
        for _, bk in pairs:
            assert f"wgmma_ss<{bk}>(float (&d)[{bk // 2}]" in hopper, bk


def test_check_cuda_rejects_a_pair_not_compiled_for_the_head_dim():
    """The wrapper's checks run before the device's: a pair of the other
    head dim is refused (ValueError "blocks"), a pair of this one passes
    them and meets the device check."""
    q64 = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    q96 = torch.zeros(1, 1, 8, 96, dtype=torch.bfloat16)
    for q, bad, good in ((q64, (128, 80), (128, 128)), (q64, (128, 48), (128, 32)),
                         (q96, (128, 32), (128, 80)), (q96, (64, 64), (128, 48))):
        with pytest.raises(ValueError, match="blocks"):
            tfv._check_cuda(q, q, q, *bad, 0)
        with pytest.raises(ValueError, match="unsupported device"):
            tfv._check_cuda(q, q, q, *good, 0)
    q320 = torch.zeros(1, 1, 8, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfv._check_cuda(q320, q320, q320, 128, 80, 0)
