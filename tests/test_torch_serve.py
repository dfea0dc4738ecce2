"""The port's `serve` on the CPU (`--device cpu`): the cases of
`tests/test_serve.py` that exist on one device, rerun on the port. Batch
mode (text and `.jsonl`, a `.jsonl` row bit-equal to its solo request,
validation, the precompute preflight, warm-up shapes, mode selection,
`--dp`/`--tp` outside torchrun), the HTTP endpoint (health, stamped PNGs, the
400/413 rules, image fields, metrics, the device lock, drain), a LoRA at
scale 0, and `_request_metadata` against the JAX server's."""

import base64
import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from f_lite_tpu import serve as jserve
from f_lite_tpu_torch import serve as tserve
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder, caption_cache_key
from f_lite_tpu_torch.utils.image import png_bytes_with_metadata, read_metadata, read_png
from f_lite_tpu_torch.utils.safetensors import save_file
from test_torch_frontends import tiny_pipeline


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_model")
    tiny_pipeline().save_pretrained(d)
    return d


def _main(model_dir, *argv):
    return tserve.main(["--model", str(model_dir), "--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# batch mode
# ---------------------------------------------------------------------------

def test_batch_serving(model_dir, tmp_path):
    pf = tmp_path / "prompts.txt"
    pf.write_text("a cat\na dog\na bird\na fish\na horse\n")
    out = tmp_path / "outs"
    manifest = _main(model_dir, "--prompts", str(pf), "--batch_size", "2",
                     "--width", "16", "--height", "16", "--steps", "1",
                     "--negative_prompt", "blurry", "--no_text_encoder",
                     "--output_dir", str(out))
    assert len(manifest["images"]) == 5  # the padded row is dropped
    assert (out / "00004.png").exists() and not (out / "00005.png").exists()
    m = json.loads((out / "manifest.json").read_text())
    assert m["images_per_min"] > 0
    meta = read_metadata(out / "00002.png")
    assert meta["prompt"] == "a bird" and meta["steps"] == 1
    assert meta["negative_prompt"] == "blurry"
    assert (meta["seed"], meta["batch_size"], meta["batch_index"]) == (2, 2, 0)
    assert read_png((out / "00002.png").read_bytes()).shape == (16, 16, 3)


def test_jsonl_rows_reproduce_solo_bit_for_bit(model_dir, tmp_path):
    """A .jsonl row's image does not depend on its batch: batch 2, batch 1
    and the pipeline's own solo draw give the same pixels."""
    jf = tmp_path / "p.jsonl"
    jf.write_text("\n".join([
        '{"prompt": "a cat", "seed": 7}',
        '{"prompt": "a dog", "negative_prompt": "blurry"}',
        '{"prompt": "a bird", "seed": 42}',
    ]) + "\n")
    base = ["--prompts", str(jf), "--width", "16", "--height", "16", "--steps", "2",
            "--seed", "100", "--no_text_encoder"]
    m2 = _main(model_dir, *base, "--batch_size", "2", "--output_dir", str(tmp_path / "b2"))
    m1 = _main(model_dir, *base, "--batch_size", "1", "--output_dir", str(tmp_path / "b1"))
    assert [r["seed"] for r in m2["images"]] == [7, 101, 42]
    assert [r["seed"] for r in m1["images"]] == [7, 101, 42]
    pixels = {(b, i): read_png((tmp_path / b / f"{i:05d}.png").read_bytes())
              for b in ("b1", "b2") for i in range(3)}
    for i in range(3):
        np.testing.assert_array_equal(pixels["b2", i], pixels["b1", i])
    meta = read_metadata(tmp_path / "b2" / "00001.png")
    assert meta["negative_prompt"] == "blurry" and meta["seed"] == 101
    assert "batch_size" not in meta  # rows reproduce alone
    pipe = FLitePipeline.from_pretrained(model_dir, device="cpu")
    pipe.text_encoder = ZeroTextEncoder(32, seq_len=PSEUDO_TEXT_LEN)
    for i, (prompt, neg, seed) in enumerate([("a cat", None, 7), ("a dog", "blurry", 101)]):
        solo = pipe(prompt=prompt, negative_prompt=neg, height=16, width=16,
                    num_inference_steps=2, guidance_scale=6.0, pad_context_to=128,
                    generator=torch.Generator("cpu").manual_seed(seed)).images[0]
        np.testing.assert_array_equal(pixels["b2", i], solo)


@pytest.mark.parametrize("line,frag", [
    ('{"prompt": ""}', "non-empty"),
    ('{"prompt": "x", "width": 32}', "unknown keys"),
    ('{"prompt": "x", "seed": "five"}', "seed must be"),
    ("not json", "invalid JSON"),
])
def test_jsonl_validation(model_dir, tmp_path, line, frag):
    jf = tmp_path / "p.jsonl"
    jf.write_text(line + "\n")
    with pytest.raises(SystemExit, match=frag):
        _main(model_dir, "--prompts", str(jf), "--width", "16", "--height", "16")


def _cache(root, captions, dim=32, rows=8, seed=0):
    (root / "text_embeddings").mkdir(parents=True)
    rs = np.random.RandomState(seed)
    for cap in captions:
        np.save(root / "text_embeddings" / f"embedding_{caption_cache_key(cap)}.npy",
                rs.randn(rows, dim).astype(np.float32))
    return root


def test_precomputed_preflight_fails_fast(tmp_path):
    """A caption missing from the cache (negatives too) fails before the
    model load: the model path does not even exist."""
    cache = _cache(tmp_path / "cache", ["a cat"])
    pf = tmp_path / "p.txt"
    pf.write_text("a cat\n")
    with pytest.raises(SystemExit, match="not in the precompute"):
        _main(tmp_path / "no_model", "--prompts", str(pf), "--precomputed_dir",
              str(cache), "--negative_prompt", "never cached",
              "--width", "16", "--height", "16")


def test_warmup_shapes_parse_and_validate(model_dir):
    assert tserve._parse_warmup_shapes("1344x896, 896X1344") == [(1344, 896), (896, 1344)]
    with pytest.raises(SystemExit, match="bad entry"):
        tserve._parse_warmup_shapes("1024")
    with pytest.raises(SystemExit, match="multiples of 16"):
        tserve._parse_warmup_shapes("1000x1000")
    with pytest.raises(SystemExit, match="HTTP mode"):
        _main(model_dir, "--prompts", "x.txt", "--warmup_shapes", "1024x1024")


def test_mode_selection_requires_exactly_one(model_dir):
    with pytest.raises(SystemExit, match="exactly one"):
        _main(model_dir)
    with pytest.raises(SystemExit, match="exactly one"):
        _main(model_dir, "--prompts", "x.txt", "--http_port", "8080")


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_multi_gpu_flags_are_not_ported_yet(model_dir, tmp_path, flag, monkeypatch):
    """Multi-GPU serving is ported: outside torchrun, --dp / --tp 2 exit
    with a message that names torchrun, in both modes and before the load
    (the runs across ranks are in tests/test_torch_tensor_parallel.py)."""
    from f_lite_tpu_torch.parallel.mesh import TORCHRUN_VARS

    for v in TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    pf = tmp_path / "p.txt"
    pf.write_text("x\n")
    with pytest.raises(SystemExit, match="under torchrun: torchrun --nproc_per_node 2"):
        _main(model_dir, "--prompts", str(pf), flag, "2", "--batch_size", "2")
    args = tserve.parse_args(["--model", str(model_dir), "--http_port", "0", flag, "2",
                              "--device", "cpu"])
    with pytest.raises(SystemExit, match="under torchrun"):
        tserve.build_pipeline(args)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _start(pipe, args):
    srv = tserve.make_http_server(pipe, args, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(srv, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(_url(srv, "/generate"), data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as resp:
        return resp.headers, resp.read()


@pytest.fixture(scope="module")
def http_args(model_dir):
    return tserve.parse_args(["--model", str(model_dir), "--http_port", "0",
                              "--width", "16", "--height", "16", "--steps", "1",
                              "--no_text_encoder", "--device", "cpu"])


@pytest.fixture(scope="module")
def server(http_args):
    srv = _start(tserve.build_pipeline(http_args), http_args)
    yield srv
    _stop(srv)


def _b64_png(w=16, h=16, color=(200, 30, 30)):
    img = np.empty((h, w, 3), np.uint8)
    img[...] = color
    return base64.b64encode(png_bytes_with_metadata(img)).decode()


def _b64_huge_header_png(w=100_000, h=100_000):
    """A header-only PNG declaring huge dimensions: refused on the header,
    without decoding."""
    import struct
    import zlib

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"")) + chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def _b64_bomb_png(w=16, h=16, inflated=64 << 20):
    """A small PNG of the request's size whose image data inflates far past
    what its header needs: refused without inflating it all."""
    import struct
    import zlib

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(bytes(inflated), 9)) + chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def test_healthz(server):
    _, body = _get(server, "/healthz")
    body = json.loads(body)
    assert body["status"] == "ok" and body["default"]["width"] == 16
    assert body["device"] == "cpu"


def test_generate_returns_stamped_png(server):
    status, headers, body = _post(server, {"prompt": "a cat"})
    assert status == 200, body
    assert headers["Content-Type"] == "image/png"
    meta = read_metadata(body)
    assert meta["prompt"] == "a cat"
    assert meta["seed"] == int(headers["X-F-Lite-Seed"])
    # automatic seeds advance: the same body gets another seed
    s2, h2, _ = _post(server, {"prompt": "a cat"})
    assert s2 == 200 and int(h2["X-F-Lite-Seed"]) != meta["seed"]


def test_generate_explicit_seed_and_shape(server, http_args):
    status, headers, body = _post(server, {"prompt": "a dog", "seed": 7, "width": 32,
                                           "height": 16, "steps": 2})
    assert status == 200, body
    assert headers["X-F-Lite-Seed"] == "7"
    got = read_png(body)
    assert got.shape == (16, 32, 3)
    # the pipeline's own call with that seed
    pipe = tserve.build_pipeline(http_args)
    want = pipe(prompt="a dog", height=16, width=32, num_inference_steps=2,
                pad_context_to=128, generator=torch.Generator("cpu").manual_seed(7))
    np.testing.assert_array_equal(got, want.images[0])


@pytest.mark.parametrize("body,frag", [
    ({}, "prompt"),
    ({"prompt": ""}, "prompt"),
    ({"prompt": "x", "width": 20}, "multiples of 16"),
    ({"prompt": "x", "width": 4096}, "width"),
    ({"prompt": "x", "steps": 0}, "steps"),
    ({"prompt": "x", "seed": -1}, "seed"),
    ({"prompt": "x", "sampler": "nope"}, "sampler"),
    ({"prompt": "x", "guidance_scale": "six"}, "guidance_scale"),
])
def test_bad_requests_are_400(server, body, frag):
    status, _, resp = _post(server, body)
    assert status == 400
    assert frag in json.loads(resp)["error"]


def test_oversized_body_is_413_without_buffering(server):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.putrequest("POST", "/generate")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(1 << 31))  # 2 GiB declared, none sent
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    conn.close()


def test_invalid_json_is_400(server):
    status, _, _ = _post(server, b"{nope")
    assert status == 400


def test_img2img_over_http(server):
    # 4 steps: strength 0.5 starts at row 2 (at 1 step it would round to
    # the whole trajectory, text to image)
    status, _, body = _post(server, {"prompt": "repaint", "seed": 3, "steps": 4,
                                     "image": _b64_png(), "strength": 0.5})
    assert status == 200, body
    meta = read_metadata(body)
    assert meta["strength"] == 0.5 and "inpaint" not in meta
    s2, _, body2 = _post(server, {"prompt": "repaint", "seed": 3, "steps": 4})
    assert s2 == 200 and not np.array_equal(read_png(body2), read_png(body))


def test_inpaint_over_http(server):
    status, _, body = _post(server, {
        "prompt": "fix the middle", "seed": 4, "image": _b64_png(),
        "mask_image": _b64_png(color=(255, 255, 255)), "strength": 1.0})
    assert status == 200, body
    assert read_metadata(body)["inpaint"] is True


@pytest.mark.parametrize("body,frag", [
    ({"prompt": "x", "image": "!!!notb64"}, "invalid base64"),
    ({"prompt": "x", "image": "aGVsbG8="}, "not a decodable image"),
    ({"prompt": "x", "mask_image": "__VALID_PNG__"}, "requires image"),
    ({"prompt": "x", "strength": 2.0}, None),  # no image: ignored
    ({"prompt": "x", "image": "__HUGE_PNG__"}, "too large"),
    ({"prompt": "x", "image": "__BOMB_PNG__"}, "inflates past"),
])
def test_image_field_validation(server, body, frag):
    subst = {"__VALID_PNG__": _b64_png, "__HUGE_PNG__": _b64_huge_header_png,
             "__BOMB_PNG__": _b64_bomb_png}
    body = {k: subst[v]() if v in subst else v for k, v in body.items()}
    status, _, resp = _post(server, body)
    if frag is None:
        assert status == 200
    else:
        assert status == 400
        assert frag in json.loads(resp)["error"]


def test_image_field_without_pil_needs_the_requested_size(server, monkeypatch):
    """Without PIL an upload of another size than the request's is a 400
    (the pipeline cannot resize it); a 16-bit PNG is one too."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    status, _, resp = _post(server, {"prompt": "x", "image": _b64_png(w=32)})
    assert status == 400 and "needs PIL" in json.loads(resp)["error"]
    status, _, resp = _post(server, {"prompt": "x", "image": base64.b64encode(
        b"GIF89a").decode()})
    assert status == 400 and "needs PIL" in json.loads(resp)["error"]
    status, _, body = _post(server, {"prompt": "x", "image": _b64_png(), "seed": 1})
    assert status == 200, body


def test_metrics_endpoint(server):
    _post(server, {"prompt": "metrics probe", "seed": 99})
    headers, body = _get(server, "/metrics")
    assert headers["Content-Type"].startswith("text/plain")
    body = body.decode()
    assert 'f_lite_requests_total{endpoint="generate",status="200"}' in body
    assert "f_lite_images_total" in body and "f_lite_generate_seconds_p50" in body
    assert "f_lite_compiled_variants" not in body  # no compile cache here
    _post(server, {"prompt": ""})
    _, body = _get(server, "/metrics")
    assert 'status="400"' in body.decode()


def test_metrics_counts_what_was_sent(http_args):
    """On a fresh server the counters equal the requests sent."""
    srv = _start(tserve.build_pipeline(http_args), http_args)
    try:
        for i in range(3):
            assert _post(srv, {"prompt": f"p{i}", "seed": i})[0] == 200
        assert _post(srv, {"prompt": ""})[0] == 400
        _, body = _get(srv, "/metrics")
    finally:
        _stop(srv)
    lines = dict(line.rsplit(" ", 1) for line in body.decode().splitlines()
                 if not line.startswith("#"))
    assert lines['f_lite_requests_total{endpoint="generate",status="200"}'] == "3"
    assert lines['f_lite_requests_total{endpoint="generate",status="400"}'] == "1"
    assert lines["f_lite_images_total"] == "3"
    # the host clock's sum; device seconds only from CUDA events (none on the
    # CPU); no batcher, so no queue wait
    assert float(lines["f_lite_generate_seconds_total"]) > 0
    assert lines["f_lite_device_seconds_total"] == "0.000"
    assert lines["f_lite_queue_seconds_total"] == "0.000"
    assert lines["f_lite_dispatches_total"] == "3"
    assert float(lines["f_lite_batch_rows_avg"]) == 1.0


def test_batcher_counts_queue_wait_and_the_leaders_device_seconds():
    """The batcher's queue counter runs from enqueue to dispatch, and a
    dispatch's device seconds sum its dp groups' leaders' (a stand-in
    group answers for the ranks)."""
    calls = []

    class Group:
        def call(self, kind, payload):
            calls.append((kind, len(payload[1])))
            return [(b"a", 0.5, 0.25), (b"b", 0.4, 0.125)]

    args = types.SimpleNamespace(dp=2, batch_window_ms=200.0)
    batcher = tserve.RequestBatcher.from_args(None, args, Group())
    batcher.metrics = metrics = tserve.ServerMetrics()
    req = dict(width=16, height=16, steps=2, sampler="euler", guidance_scale=6.0)
    try:
        first = batcher.submit(dict(req, prompt="p"))
        time.sleep(0.05)
        second = batcher.submit(dict(req, prompt="q"))
        assert first.result(timeout=30) == (b"a", 0.5, 2)
        assert second.result(timeout=30) == (b"b", 0.5, 2)
    finally:
        batcher.stop()
    assert calls == [("rows", 2)]
    assert metrics.generate_seconds == 0.5 and metrics.device_seconds == 0.375
    assert metrics.queue_seconds >= 0.05  # the first waited for the second
    assert "f_lite_queue_seconds_total" in metrics.render()


def test_unknown_paths_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert ei.value.code == 404


def test_concurrent_requests_serialize_on_the_device_lock(server):
    with ThreadPoolExecutor(3) as ex:
        rs = list(ex.map(lambda i: _post(server, {"prompt": f"p{i}", "seed": i}),
                         range(3)))
    assert all(r[0] == 200 for r in rs)
    assert sorted(int(r[1]["X-F-Lite-Seed"]) for r in rs) == [0, 1, 2]


def test_uncached_caption_is_400_not_500(model_dir, tmp_path):
    cache = _cache(tmp_path / "cache", ["a cat"])
    args = tserve.parse_args(["--model", str(model_dir), "--http_port", "0",
                              "--width", "16", "--height", "16", "--steps", "1",
                              "--precomputed_dir", str(cache), "--device", "cpu"])
    srv = _start(tserve.build_pipeline(args), args)
    try:
        assert _post(srv, {"prompt": "a cat", "seed": 1})[0] == 200
        status, _, resp = _post(srv, {"prompt": "a dog", "seed": 1})
        assert status == 400 and "precompute" in json.loads(resp)["error"]
    finally:
        _stop(srv)


def test_warmup_does_not_need_a_cached_caption(model_dir, tmp_path):
    cache = _cache(tmp_path / "cache", ["x"])
    args = tserve.parse_args(["--model", str(model_dir), "--http_port", "0",
                              "--width", "16", "--height", "16", "--steps", "1",
                              "--warmup_shapes", "32x16",
                              "--precomputed_dir", str(cache), "--device", "cpu"])
    assert tserve.warm_up(tserve.build_pipeline(args), args) > 0  # must not raise


def test_drain_rejects_new_and_finishes_inflight():
    started = threading.Event()

    class SlowPipe:
        text_encoder = ZeroTextEncoder(8, 4)
        vae_scale_factor = 8
        device = torch.device("cpu")

        def __call__(self, **kw):
            started.set()
            time.sleep(1.5)
            return types.SimpleNamespace(
                images=np.zeros((1, kw["height"], kw["width"], 3), np.uint8))

    args = tserve.parse_args(["--model", "x", "--http_port", "0", "--width", "16",
                              "--height", "16", "--steps", "1", "--no_text_encoder",
                              "--device", "cpu"])
    srv = _start(SlowPipe(), args)
    results = []

    def post():
        results.append(_post(srv, {"prompt": "x", "seed": 1})[0])

    t = threading.Thread(target=post)
    t.start()
    assert started.wait(30)  # the request is on the device
    srv.begin_drain()
    assert _post(srv, {"prompt": "y"})[0] == 503
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(srv, "/healthz"), timeout=30)
    assert ei.value.code == 503
    assert srv.drain_wait(30.0)
    t.join(timeout=30)
    assert not t.is_alive() and results == [200]
    _stop(srv)


def test_lora_served_at_scale_zero_is_the_base(model_dir, tmp_path):
    rs = np.random.RandomState(3)
    factors = {}
    for i in range(2):
        factors[f"blocks_{i}.self_attn.qkv.lora_a"] = rs.randn(64, 2).astype(np.float32)
        factors[f"blocks_{i}.self_attn.qkv.lora_b"] = rs.randn(2, 192).astype(np.float32)
    save_file(factors, tmp_path / "lora_weights.safetensors")

    def images(*extra):
        args = tserve.parse_args(["--model", str(model_dir), "--prompts", "unused.txt",
                                  "--no_text_encoder", "--device", "cpu", *extra])
        return tserve.build_pipeline(args)(
            prompt="l", height=16, width=16, num_inference_steps=1,
            generator=torch.Generator("cpu").manual_seed(7), output_type="np").images

    lora = ["--lora_path", str(tmp_path / "lora_weights.safetensors")]
    base, merged, zero = images(), images(*lora), images(*lora, "--lora_scale", "0")
    assert not np.array_equal(base, merged)
    np.testing.assert_array_equal(base, zero)


@pytest.mark.parametrize("with_image", [False, True])
def test_request_metadata_equals_jax(with_image):
    r = dict(prompt="a cat", negative_prompt=None, width=32, height=16, steps=2,
             guidance_scale=6.0, sampler="ab2", seed=5, image=None, mask_image=None,
             strength=0.8)
    if with_image:
        r.update(image=np.zeros((16, 32, 3), np.uint8), strength=0.5,
                 mask_image=np.zeros((8, 16), np.uint8))
    argv = ["--model", "m", "--http_port", "0", "--quantize",
            "--guidance_interval", "0.1", "0.9"]
    want = jserve._request_metadata(r, jserve.parse_args(argv))
    assert tserve._request_metadata(r, tserve.parse_args(argv)) == want
