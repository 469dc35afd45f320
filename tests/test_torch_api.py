"""The port's HTTP serving frontend (lhrs_bot_tpu_torch.serve.api) over a
live socket with the tiny model, on the CPU.

Each test of tests/test_api.py (the JAX frontend's, the behavioural
oracle) has its counterpart here under the same name, run over the port's
contiguous and paged schedulers. Then the port is held to the JAX
frontend: the same prompts (text, one image, two images, a chat with a
system message, history and an image_url) build equal requests (ids and
image arrays exactly) and give equal greedy ids over HTTP, with both
packages on the same weights (JAX `init_vlm_params(PRNGKey(0))` bridged
with `params_from_numpy`, float32) and tests/fake_tokenizer.py. A PNG
request is served with PIL unimportable; `lhrs_serve_torch.py` builds a
server from tests/fixtures/tiny_eval.yaml with --device cpu.
"""

import base64
import json
import runpy
import socket
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.serve import api as j_api
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.serve import scheduler as j_sched
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.serve import engine as t_engine
from lhrs_bot_tpu_torch.serve import paged as t_paged
from lhrs_bot_tpu_torch.serve.api import ServingFrontend, make_handler
from lhrs_bot_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

from .fake_tokenizer import FakeTokenizer

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, JAX engine, port engine) on the same weights."""
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    je = j_engine.GenerationEngine(j_cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        max_seq_len=96, device=CPU, **F32)
    return j_cfg, params, je, te


def _scheduler(te, kind, max_batch=2, max_seq_len=96, **kw):
    common = dict(max_batch=max_batch, prompt_bucket=16, device=CPU, **F32,
                  **kw)
    if kind == "paged":
        return t_paged.PagedScheduler(
            te.cfg, te.params, te.llama_params, num_pages=40, page_size=16,
            max_seq_len=max_seq_len, **common)
    return ContinuousBatchingScheduler(te.cfg, te.params, te.llama_params,
                                       max_seq_len=max_seq_len, **common)


def _start(frontend):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module", params=["contiguous", "paged"])
def served(request, model):
    te = model[3]
    frontend = ServingFrontend(_scheduler(te, request.param),
                               FakeTokenizer(te.cfg.llama.vocab_size),
                               image_size=28)
    httpd, url = _start(frontend)
    yield url, frontend
    httpd.shutdown()
    frontend.shutdown()


@pytest.fixture
def server(served):
    return served[0]


def _post(url, payload, route="/generate"):
    req = urllib.request.Request(
        url + route, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(arr):
    """A PNG of an (H, W, 3) uint8 array, written with zlib (no PIL)."""
    h, w, _ = arr.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    rows = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _b64(arr):
    return base64.b64encode(_png(arr)).decode()


class TestFrontendRobustness:
    class _FlakySched:
        """Duck-typed scheduler: the first admit raises, later ones
        succeed."""

        def __init__(self):
            self.active = np.zeros(2, bool)
            self.slot_req = [None, None]
            self.calls = 0

        def admit(self, reqs):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            for r in reqs:
                r.output_ids = [5]
                r.done = True
            return len(reqs)

        def step(self, waiting=0):
            return 0

    def test_worker_survives_scheduler_error(self):
        frontend = ServingFrontend(self._FlakySched(), FakeTokenizer(),
                                   image_size=28)
        try:
            first = frontend.generate_blocking("a", None, 4, timeout=30)
            assert first["finish_reason"] == "error"
            assert "boom" in first["error"]
            second = frontend.generate_blocking("b", None, 4, timeout=30)
            assert second["finish_reason"] == "stop"
        finally:
            frontend.shutdown()

    def test_build_request_single_image_invariant(self):
        frontend = ServingFrontend(self._FlakySched(), FakeTokenizer(),
                                   image_size=28)
        try:
            img = np.zeros((28, 28, 3), np.uint8)
            req = frontend.build_request("<image> a <image> b <image>", img,
                                         4)
            assert int((req.input_ids < 0).sum()) == 1
            req2 = frontend.build_request("<image> hello <image>", None, 4)
            assert int((req2.input_ids < 0).sum()) == 0
            req3 = frontend.build_request("two", [img, img], 4)
            assert int((req3.input_ids < 0).sum()) == 2
            assert req3.image.shape == (2, 28, 28, 3)
        finally:
            frontend.shutdown()


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
class TestFrontendCancel:
    def test_cancel_in_flight_request(self, model, kind):
        te = model[3]
        sched = _scheduler(te, kind, eos_token_id=-1, tokens_per_tick=1)
        frontend = ServingFrontend(sched,
                                   FakeTokenizer(te.cfg.llama.vocab_size),
                                   image_size=28)
        try:
            req = frontend.build_request("count to one thousand", None, 80)
            ev = frontend.submit(req)
            deadline = time.monotonic() + 60
            while not req.output_ids and time.monotonic() < deadline:
                time.sleep(0.01)
            assert req.output_ids, "generation never started"
            assert frontend.cancel(req.uid)
            assert ev.wait(timeout=30)
            assert req.done and req.cancelled
            assert len(req.output_ids) < 80
            assert not frontend.cancel(req.uid)  # already finished
            out = frontend.generate_blocking("hello", None, 3, timeout=60)
            assert out["finish_reason"] == "stop"
        finally:
            frontend.shutdown()

    def test_cancel_unknown_uid(self, model, kind):
        te = model[3]
        frontend = ServingFrontend(_scheduler(te, kind, max_batch=1,
                                              max_seq_len=64),
                                   FakeTokenizer(te.cfg.llama.vocab_size),
                                   image_size=28)
        try:
            assert not frontend.cancel(12345)
        finally:
            frontend.shutdown()


class TestServingAPI:
    def test_health(self, server):
        with urllib.request.urlopen(server + "/health", timeout=30) as resp:
            data = json.loads(resp.read())
        assert data["status"] == "ok"
        assert data["active"] == 0

    def test_generate_text_only(self, server):
        status, data = _post(server, {"prompt": "describe the scene",
                                      "max_new_tokens": 4})
        assert status == 200
        assert data["finish_reason"] == "stop"
        assert isinstance(data["tokens"], list)
        assert 1 <= len(data["tokens"]) <= 4

    def test_generate_with_image(self, server):
        status, data = _post(server, {
            "prompt": "what is this",
            "image_b64": _b64(np.zeros((32, 32, 3), np.uint8)),
            "max_new_tokens": 3})
        assert status == 200
        assert data["finish_reason"] == "stop"

    def test_concurrent_requests(self, server):
        results = []

        def call(i):
            results.append(_post(server, {"prompt": f"query {i}",
                                          "max_new_tokens": 3}))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 4
        assert all(s == 200 for s, _ in results)

    def test_generate_stream(self, server):
        req = urllib.request.Request(
            server + "/generate_stream",
            data=json.dumps({"prompt": "stream me",
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        lines = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "application/x-ndjson"
            for raw in resp:
                lines.append(json.loads(raw))
        assert lines[-1]["done"] is True
        assert lines[-1]["finish_reason"] == "stop"
        toks = [line["token"] for line in lines[:-1]]
        assert 1 <= len(toks) <= 4
        assert "".join(line["text_delta"] for line in lines[:-1]) == \
            lines[-1]["text"]
        _, blocking = _post(server, {"prompt": "stream me",
                                     "max_new_tokens": 4})
        assert toks == blocking["tokens"]

    @pytest.mark.parametrize("kind", ["contiguous", "paged"])
    def test_stream_disconnect_cancels(self, model, kind):
        """Closing the streaming connection mid-generation frees the
        slot."""
        te = model[3]
        sched = _scheduler(te, kind, max_batch=1, eos_token_id=-1,
                           tokens_per_tick=1)
        frontend = ServingFrontend(sched,
                                   FakeTokenizer(te.cfg.llama.vocab_size),
                                   image_size=28)
        httpd, _ = _start(frontend)
        try:
            body = json.dumps({"prompt": "never ending",
                               "max_new_tokens": 80}).encode()
            s = socket.create_connection(("127.0.0.1", httpd.server_port),
                                         timeout=60)
            s.sendall(b"POST /generate_stream HTTP/1.1\r\n"
                      b"Host: x\r\nContent-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            s.recv(512)  # headers and the first chunks started flowing
            s.close()
            # the worker thread frees the slot, then its pages: wait for
            # both before reading either
            deadline = time.monotonic() + 60
            while (sched.active.any() or any(getattr(sched, "slot_pages",
                                                     ()))) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not sched.active.any(), "slot never freed on disconnect"
            if kind == "paged":
                assert not any(sched.slot_pages)
        finally:
            httpd.shutdown()
            frontend.shutdown()

    def test_bad_request(self, server):
        status, data = _post(server, {"no_prompt": True})
        assert status == 400
        assert "error" in data

    def test_corrupt_image_rejected(self, server):
        raw = bytearray(_png(np.zeros((8, 8, 3), np.uint8)))
        raw[-20] ^= 0xFF  # inside IDAT: its CRC fails
        status, data = _post(server, {
            "prompt": "what", "max_new_tokens": 2,
            "image_b64": base64.b64encode(bytes(raw)).decode()})
        assert status == 400
        assert "CRC" in data["error"]

    def test_per_request_sampling_over_http(self, server):
        base = {"prompt": "describe the scene", "max_new_tokens": 6}
        _, greedy_default = _post(server, dict(base))
        _, greedy_explicit = _post(server, dict(base, temperature=0.0))
        assert greedy_default["tokens"] == greedy_explicit["tokens"]
        hot = {tuple(_post(server, dict(base, temperature=20.0,
                                        top_p=1.0))[1]["tokens"])
               for _ in range(4)}
        assert len(hot) > 1, "temperature=20 never diverged over HTTP"

    def test_vocab_mismatch_rejected(self, model):
        te = model[3]
        frontend = ServingFrontend(_scheduler(te, "contiguous", max_batch=1,
                                              max_seq_len=64),
                                   FakeTokenizer(vocab_size=2000),
                                   image_size=28)
        try:
            words = " ".join(f"w{i}xq" for i in range(16))
            with pytest.raises(ValueError, match="vocab"):
                frontend.build_request(words, None, 4)
        finally:
            frontend.shutdown()

    def test_generate_multi_image(self, server):
        rng = np.random.default_rng(3)
        imgs = [rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8)
                for _ in range(2)]
        status, data = _post(server, {
            "prompt": "compare <image> with <image>",
            "images_b64": [_b64(i) for i in imgs],
            "max_new_tokens": 3})
        assert status == 200
        assert data["finish_reason"] == "stop"
        assert 1 <= len(data["tokens"]) <= 3

    def test_too_many_images_rejected(self, server):
        """Images that leave the prompt no room in the cache (11 rows an
        image past its marker, max_seq_len 96) are refused with 400 on
        the HTTP thread; the worker, and so every other user, goes on."""
        img = np.random.default_rng(5).integers(
            0, 255, size=(32, 32, 3)).astype(np.uint8)
        status, data = _post(server, {"prompt": "compare them",
                                      "images_b64": [_b64(img)] * 9,
                                      "max_new_tokens": 3})
        assert status == 400 and "no room" in data["error"]
        status, data = _post(server, {"prompt": "compare them",
                                      "images_b64": [_b64(img)] * 2,
                                      "max_new_tokens": 3})
        assert status == 200 and data["finish_reason"] == "stop"

    def test_stats_route(self, served):
        url, frontend = served
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            data = json.loads(r.read())
        assert data["status"] == "ok"
        assert "active" in data and "queued" in data
        assert ("pool" in data) == hasattr(frontend.sched, "pool_stats")

    def test_chat_completions(self, server):
        body = {"model": "lhrs", "max_tokens": 4, "messages": [
            {"role": "system", "content": "you are a remote sensing bot"},
            {"role": "user", "content": "hello there"},
            {"role": "assistant", "content": "hi"},
            {"role": "user", "content": "what can you see"}]}
        status, data = _post(server, body, "/v1/chat/completions")
        assert status == 200
        assert data["object"] == "chat.completion"
        choice = data["choices"][0]
        assert choice["message"]["role"] == "assistant"
        assert choice["finish_reason"] in ("stop", "length")
        u = data["usage"]
        assert u["total_tokens"] == (u["prompt_tokens"]
                                     + u["completion_tokens"])
        assert 1 <= u["completion_tokens"] <= 4

    def test_chat_completions_stream_and_vision(self, server):
        data_url = ("data:image/png;base64,"
                    + _b64(np.zeros((24, 24, 3), np.uint8)))
        body = {"stream": True, "max_tokens": 3, "messages": [
            {"role": "user", "content": [
                {"type": "text", "text": "describe this"},
                {"type": "image_url", "image_url": {"url": data_url}}]}]}
        req = urllib.request.Request(
            server + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        events = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            for raw in resp:
                raw = raw.strip()
                if not raw.startswith(b"data: "):
                    continue
                payload = raw[len(b"data: "):]
                events.append("DONE" if payload == b"[DONE]"
                              else json.loads(payload))
        assert events[-1] == "DONE"
        assert events[-2]["choices"][0]["finish_reason"] in ("stop",
                                                             "length")
        deltas = [e["choices"][0]["delta"].get("content", "")
                  for e in events[:-2] if e != "DONE"]
        assert any(deltas)

    def test_chat_bad_roles(self, server):
        body = {"messages": [{"role": "user", "content": "a"},
                             {"role": "assistant", "content": "b"}]}
        status, _ = _post(server, body, "/v1/chat/completions")
        assert status == 400  # the last message must be role=user
        body = {"messages": [{"role": "robot", "content": "a"}]}
        assert _post(server, body, "/v1/chat/completions")[0] == 400

    @pytest.mark.parametrize("kind", ["contiguous", "paged"])
    def test_warmup(self, model, kind):
        te = model[3]
        sched = _scheduler(te, kind, max_seq_len=64)
        frontend = ServingFrontend(sched,
                                   FakeTokenizer(te.cfg.llama.vocab_size),
                                   image_size=28)
        try:
            dt = frontend.warmup(prompt_lens=(8, 24), batches=(1, 2),
                                 max_new=3)
            assert dt > 0
            assert not sched.active.any()
            out = frontend.generate_blocking("hello", None, 3, timeout=60)
            assert out["finish_reason"] == "stop"
        finally:
            frontend.shutdown()

    def test_unknown_route(self, server):
        for route in ("/nope", "/generate"):
            try:
                with urllib.request.urlopen(server + route, timeout=30) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
            assert status == 404
        assert _post(server, {"prompt": "x"}, "/nope")[0] == 404


# -- parity with the JAX frontend --------------------------------------------

RNG = np.random.default_rng(21)
IMAGES = [RNG.integers(0, 256, (30 + 7 * i, 41 - 5 * i, 3)).astype(np.uint8)
          for i in range(3)]
CHAT = [{"role": "system", "content": "you describe airports"},
        {"role": "user", "content": "hello"},
        {"role": "assistant", "content": "hi, send an image"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is in it?"},
            {"type": "image_url", "image_url": {
                "url": "data:image/png;base64," + _b64(IMAGES[2])}}]}]
CASES = {
    "text": {"prompt": "describe the scene in detail"},
    "image": {"prompt": "what is this", "image_b64": _b64(IMAGES[0])},
    "two_images": {"prompt": "compare <image> with <image>",
                   "images_b64": [_b64(IMAGES[0]), _b64(IMAGES[1])]},
    "chat": {"messages": CHAT},
}


@pytest.fixture(scope="module")
def jax_server(model):
    j_cfg, params, je, te = model
    sched = j_sched.ContinuousBatchingScheduler(
        j_cfg, params, je.llama_params, max_batch=2, max_seq_len=96,
        compute_dtype=jnp.float32, cache_dtype=jnp.float32,
        prompt_bucket=16)
    frontend = j_api.ServingFrontend(sched,
                                     FakeTokenizer(j_cfg.llama.vocab_size),
                                     image_size=28)
    httpd, url = _start(frontend)
    yield url, frontend
    httpd.shutdown()
    frontend.shutdown()


def _build(frontend, case):
    body = CASES[case]
    if "messages" in body:
        return frontend.build_chat_request(body["messages"], 5)
    from lhrs_bot_tpu_torch.data.image_io import decode_b64

    image = None
    if "images_b64" in body:
        image = [decode_b64(b) for b in body["images_b64"]]
    elif "image_b64" in body:
        image = decode_b64(body["image_b64"])
    return frontend.build_request(body["prompt"], image, 5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_built_requests_match_jax(jax_server, served, case):
    """The port's request (prompt template, markers, tokenization, image
    decode and resize) equals the JAX frontend's exactly."""
    want, got = _build(jax_server[1], case), _build(served[1], case)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    assert got.input_ids.dtype == want.input_ids.dtype
    if want.image is None:
        assert got.image is None
    else:
        assert got.image.dtype == np.uint8
        np.testing.assert_array_equal(got.image, want.image)
    n_img = {"text": 0, "image": 1, "two_images": 2, "chat": 1}[case]
    assert int((got.input_ids == -200).sum()) == n_img


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_ids_over_http_match_jax(jax_server, served, case):
    body = dict(CASES[case])
    if "messages" in body:
        body["max_tokens"] = 5
        status_j, want = _post(jax_server[0], body, "/v1/chat/completions")
        status, got = _post(served[0], body, "/v1/chat/completions")
        assert status == status_j == 200
        # the text is each server's FakeTokenizer's, whose decode knows
        # only the words that instance has encoded: compare the counts
        assert got["usage"] == want["usage"]
        assert got["choices"][0]["finish_reason"] == \
            want["choices"][0]["finish_reason"]
        return
    body["max_new_tokens"] = 5
    status_j, want = _post(jax_server[0], body)
    status, got = _post(served[0], body)
    assert status == status_j == 200
    assert got["tokens"] == want["tokens"]
    assert got["finish_reason"] == want["finish_reason"] == "stop"


def test_png_request_without_pil(served, monkeypatch):
    """With PIL unimportable the port's frontend still serves a PNG
    request (its own decoder and resize), with the ids it gives with
    PIL."""
    body = dict(CASES["image"], max_new_tokens=4)
    _, with_pil = _post(served[0], body)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    status, data = _post(served[0], body)
    assert status == 200
    assert data == with_pil
    jpeg = base64.b64encode(b"\xff\xd8\xff\xe0 not a png").decode()
    status, data = _post(served[0], {"prompt": "x", "image_b64": jpeg})
    assert status == 400 and "only PNG" in data["error"]


# -- the entry point ---------------------------------------------------------

@pytest.fixture(scope="module")
def serve_main():
    return runpy.run_path(str(REPO / "lhrs_serve_torch.py"),
                          run_name="lhrs_serve_torch")


def _tiny_yaml(tmp_path):
    """tests/fixtures/tiny_eval.yaml with its model paths cleared: the
    port's loader refuses a path that does not exist (the JAX one keeps
    the random init), and no path means the byte-level tokenizer."""
    import yaml

    cfg = yaml.safe_load((REPO / "tests" / "fixtures" /
                          "tiny_eval.yaml").read_text())
    cfg["rgb_vision"]["vit_name"] = None
    cfg["text"]["path"] = None
    path = tmp_path / "tiny_eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_lhrs_serve_torch_builds_a_server(serve_main, tmp_path, paged):
    args = ["-c", _tiny_yaml(tmp_path), "--device", "cpu", "--slots", "2",
            "--output", str(tmp_path / "out")]
    if paged:
        args += ["--paged", "--page-size", "16", "--pool-tokens", "512",
                 "--prefill-chunk", "32"]
    frontend, config = serve_main["build_frontend"](args)
    httpd, url = _start(frontend)
    try:
        assert isinstance(frontend.sched, t_paged.PagedScheduler) == paged
        assert frontend.tokenizer.vocab_size == 260
        with urllib.request.urlopen(url + "/health", timeout=30) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        status, data = _post(url, {"prompt": "hello there",
                                   "image_b64": _b64(IMAGES[0]),
                                   "max_new_tokens": 3})
        assert status == 200 and data["finish_reason"] == "stop"
        assert 1 <= len(data["tokens"]) <= 3
        assert (tmp_path / "out" / "config.json").exists()
    finally:
        httpd.shutdown()
        frontend.shutdown()


def test_lhrs_serve_torch_defaults_to_cuda(serve_main, tmp_path,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        serve_main["build_frontend"](["-c", _tiny_yaml(tmp_path),
                                      "--output", str(tmp_path / "out")])


@pytest.mark.parametrize("flag", [["--speculative", "2"], ["--tp", "2"]],
                         ids=["speculative", "tp"])
def test_lhrs_serve_torch_unported_flags_raise(serve_main, tmp_path, flag):
    """--tp is ported for a world of tp ranks (torchrun): in one process
    --tp 2 raises ValueError naming the world size. --speculative is
    ported: it builds a contiguous frontend whose scheduler runs
    speculative ticks and serves a request; with --paged it raises
    ValueError, as lhrs_serve.py does."""
    args = ["-c", _tiny_yaml(tmp_path), "--device", "cpu", "--output",
            str(tmp_path / "out")] + flag
    if "--tp" in flag:
        with pytest.raises(ValueError, match="world size"):
            serve_main["build_frontend"](args)
        return
    with pytest.raises(ValueError, match="paged"):
        serve_main["build_frontend"](args + ["--paged"])
    frontend, _ = serve_main["build_frontend"](args)
    httpd, url = _start(frontend)
    try:
        assert isinstance(frontend.sched, ContinuousBatchingScheduler)
        assert not isinstance(frontend.sched, t_paged.PagedScheduler)
        assert frontend.sched.speculative == 2
        status, data = _post(url, {"prompt": "hello hello hello",
                                   "max_new_tokens": 4})
        assert status == 200 and 1 <= len(data["tokens"]) <= 4
    finally:
        httpd.shutdown()
        frontend.shutdown()


@pytest.mark.parametrize("flag", [["--dp", "8"], ["--enable-amp", "false"],
                                  ["--batch-size", "4"]],
                         ids=["dp", "enable-amp", "batch-size"])
def test_lhrs_serve_torch_refuses_flags_it_does_not_read(serve_main,
                                                         tmp_path, flag):
    """The JAX trainer's common flags that nothing in the port reads are
    refused by argparse, not accepted and ignored."""
    with pytest.raises(SystemExit):
        serve_main["build_frontend"](["-c", _tiny_yaml(tmp_path), "--device",
                                      "cpu", "--output",
                                      str(tmp_path / "out")] + flag)
