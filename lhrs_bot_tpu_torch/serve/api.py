"""HTTP serving API over the continuous-batching schedulers.

Counterpart of `lhrs_bot_tpu/serve/api.py`: a stdlib-only JSON API.

  POST /generate   {"prompt": str, "image_b64": optional base64 PNG (other
                    formats need PIL), "images_b64": optional list of them
                    (one marker each), "max_new_tokens": int,
                    "temperature": float (0 = greedy), "top_p": float} ->
                   {"text": str, "tokens": [int], "finish_reason": str};
                   sampling knobs are per request though requests share
                   decode ticks
  POST /generate_stream  the same body -> newline-delimited JSON, one
                   {"token": int, "text_delta": str} per emitted token, then
                   {"done": true, "finish_reason": str, "text": str}
  POST /v1/chat/completions  OpenAI-style messages (text, or content parts
                   with base64 data: image URLs) -> a completion, or an SSE
                   stream with "stream": true
  GET  /health, /stats  -> {"status": "ok", "active", "queued",
                   "last_tick_k"} (+ "pool" for the paged scheduler)

Requests are queued; one worker thread owns the scheduler (and so the card)
and admits and ticks them, so concurrent users share decode ticks. HTTP
threads only tokenize, decode and resize images on the host. A request's
kernels are built on the worker thread at the first launch (`warmup` moves
that to start-up). `ServingFrontend.cancel(uid)` aborts a queued or
in-flight request, freeing its slot; a client that disconnects from a
stream, or a blocking call that times out, cancels its request.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..data import conversation as conv_lib
from ..data.image_io import decode_b64, decode_data_url
from ..data.preprocess import (tokenizer_image_token,
                               wrap_image_token_for_generation)
from ..data.transforms import clip_preprocess_uint8
from ..models.constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX
from .scheduler import (ContinuousBatchingScheduler, Request,
                        check_image_room)

logger = logging.getLogger("lhrs_tpu")


class ServingFrontend:
    """Prompt assembly + request queue + scheduler worker."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, tokenizer,
                 image_size: int = 224,
                 prompt_template: str = "llava_llama_2",
                 poll_interval: float = 0.005):
        self.sched = scheduler
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.prompt_template = prompt_template
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._events: Dict[int, threading.Event] = {}
        self._uid = 0
        self._uid_lock = threading.Lock()
        self._cancelled: set = set()
        self._cancel_lock = threading.Lock()
        self._poll = poll_interval
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _next_uid(self) -> int:
        with self._uid_lock:
            self._uid += 1
            return self._uid

    def build_request(self, prompt: str, image,
                      max_new_tokens: int,
                      temperature: Optional[float] = None,
                      top_p: Optional[float] = None) -> Request:
        """`image`: None, one (H, W, 3) array, or a LIST of arrays for a
        multi-image prompt (marker k in reading order pairs with image k)."""
        conv = conv_lib.conv_templates[self.prompt_template].copy()
        text = prompt
        images = ([] if image is None
                  else list(image) if isinstance(image, (list, tuple))
                  else [image])
        k = len(images)
        # marker/image invariant: the splice pairs marker j with image
        # slot j — normalize the prompt to EXACTLY k markers (surplus
        # markers would silently embed as token id 0, missing ones would
        # drop images).
        n_img = text.count(DEFAULT_IMAGE_TOKEN)
        if n_img > k:
            logger.warning("prompt has %d image tokens for %d image(s) — "
                           "keeping the first %d", n_img, k, k)
            parts = text.split(DEFAULT_IMAGE_TOKEN)
            text = (DEFAULT_IMAGE_TOKEN.join(parts[:k + 1])
                    + "".join(parts[k + 1:])).strip()
        elif n_img < k:
            missing = k - n_img
            text = (DEFAULT_IMAGE_TOKEN + "\n") * missing + text
        if k == 1:
            # single-image front-normalization + mmtag/im_start wrap; the
            # wrap collapses markers, so multi-image prompts keep theirs
            text = wrap_image_token_for_generation(text)
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        return self._finalize_request(conv, images, max_new_tokens,
                                      temperature, top_p)

    def build_chat_request(self, messages, max_new_tokens: int,
                           temperature: Optional[float] = None,
                           top_p: Optional[float] = None) -> Request:
        """OpenAI-style `messages` → conversation-template Request.

        Roles: optional leading "system" (overrides the template's system
        prompt), then alternating "user"/"assistant", ending on "user".
        A user message's content may be a string or the OpenAI vision
        list format ({"type": "text"|"image_url"} parts with base64
        data: URLs) — each image becomes a splice marker in order."""
        conv = conv_lib.conv_templates[self.prompt_template].copy()
        images: list = []
        msgs = list(messages)
        if msgs and msgs[0].get("role") == "system":
            conv.system = str(msgs[0].get("content", ""))
            msgs = msgs[1:]
        if not msgs or msgs[-1].get("role") != "user":
            raise ValueError("the last chat message must be role=user")
        role_map = {"user": conv.roles[0], "assistant": conv.roles[1]}
        for m in msgs:
            role = m.get("role")
            if role not in role_map:
                raise ValueError(f"unsupported chat role {role!r}")
            content = m.get("content", "")
            if isinstance(content, list):  # vision content parts
                texts = []
                for part in content:
                    ptype = part.get("type")
                    if ptype == "text":
                        texts.append(part.get("text", ""))
                    elif ptype == "image_url":
                        url = part.get("image_url", {}).get("url", "")
                        images.append(decode_data_url(url))
                        texts.append(DEFAULT_IMAGE_TOKEN)
                    else:
                        raise ValueError(
                            f"unsupported content part {ptype!r}")
                content = "\n".join(t for t in texts if t)
            conv.append_message(role_map[role], str(content))
        conv.append_message(conv.roles[1], None)
        return self._finalize_request(conv, images, max_new_tokens,
                                      temperature, top_p)

    def _finalize_request(self, conv, images, max_new_tokens,
                          temperature, top_p) -> Request:
        ids = np.asarray(
            tokenizer_image_token(conv.get_prompt(), self.tokenizer),
            np.int32)
        k = len(images)
        if k == 0:
            img = None
        elif k == 1:
            img = clip_preprocess_uint8(images[0], self.image_size)
        else:
            img = np.stack([clip_preprocess_uint8(im, self.image_size)
                            for im in images])
        # a tokenizer/model vocab mismatch must fail HERE (-> HTTP 400),
        # not on the worker: an out-of-vocabulary id would index past the
        # embedding table (a device-side assert on the card, which ends
        # the process's CUDA context for every user).
        cfg = getattr(self.sched, "cfg", None)
        vocab = cfg.llama.vocab_size if cfg is not None else None
        bad = (ids[(ids != IMAGE_TOKEN_INDEX)
                   & ((ids < 0) | (ids >= vocab))]
               if vocab is not None else np.empty(0, np.int32))
        if bad.size:
            raise ValueError(
                f"tokenizer produced ids outside the model vocabulary "
                f"(vocab_size={vocab}, offending ids {bad[:8].tolist()}) — "
                f"tokenizer/model mismatch")
        # a request the cache cannot hold with its images fails here too:
        # on the worker its admission would fail every co-admitted request
        if cfg is not None:
            check_image_room(len(ids), k, cfg.pooler.num_query,
                             self.sched.max_seq_len)
        return Request(uid=self._next_uid(), input_ids=ids, image=img,
                       max_new_tokens=max_new_tokens,
                       temperature=temperature, top_p=top_p)

    def submit(self, req: Request) -> threading.Event:
        ev = threading.Event()
        self._events[req.uid] = ev
        self._queue.put(req)
        return ev

    def cancel(self, uid: int) -> bool:
        """Request cancellation of a queued or in-flight request. Applied
        by the worker thread at its next loop iteration (ms): a queued
        request is dropped before admission, an in-flight one has its slot
        freed mid-generation (scheduler.cancel). The request's completion
        event fires with done=True, cancelled=True. Returns False for an
        unknown or already-finished uid."""
        ev = self._events.get(uid)
        if ev is None or ev.is_set():
            return False
        with self._cancel_lock:
            self._cancelled.add(uid)
        return True

    def warmup(self, prompt_lens=(64, 256, 1024), batches=None,
               max_new: int = 9) -> float:
        """Run dummy waves through the worker (prompt lengths x the
        power-of-two admission chunk sizes up to max_batch, by default)
        before the port binds, so the kernels' build, cuBLAS's first
        loads and the allocations of each (chunk size, width) happen at
        start-up, not inside a user's time to first token. Returns the
        elapsed seconds."""
        if batches is None:
            b, batches = 1, []
            while b <= self.sched.max_batch:
                batches.append(b)
                b *= 2
        t0 = time.monotonic()
        rng = np.random.default_rng(0)
        vocab = getattr(getattr(self.sched, "cfg", None), "llama", None)
        hi = vocab.vocab_size - 1 if vocab is not None else 200
        for b in batches:
            if b > self.sched.max_batch:
                continue
            for n in prompt_lens:
                n = max(1, min(n, self.sched.max_seq_len - max_new - 1))
                # one wave per (chunk size, width): through the worker
                # queue — the worker owns the scheduler, never race it
                reqs = [Request(uid=self._next_uid(),
                                input_ids=rng.integers(
                                    3, hi, size=(n,)).astype(np.int32),
                                max_new_tokens=max_new) for _ in range(b)]
                evs = [self.submit(r) for r in reqs]
                for ev in evs:
                    ev.wait(timeout=1200)
        dt = time.monotonic() - t0
        logger.info("serving warmup done in %.1f s "
                    "(prompt buckets %s x chunk sizes %s)",
                    dt, list(prompt_lens), list(batches))
        return dt

    def stats(self) -> Dict[str, int]:
        active = int(self.sched.active.sum())
        # the worker never step()s an idle scheduler, so the scheduler's
        # own idle reset can't fire here — gate on active so an idle
        # server reads last_tick_k=0 instead of its final dispatch size
        return {"active": active,
                "queued": self._queue.qsize(),
                "last_tick_k":
                    int(getattr(self.sched, "last_tick_k", 0))
                    if active else 0}

    def shutdown(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)

    def _run(self) -> None:
        pending = []
        self._inflight = []
        while not self._stop.is_set():
            # drain queue
            try:
                while True:
                    pending.append(self._queue.get_nowait())
            except queue.Empty:
                pass
            if self._cancelled:
                with self._cancel_lock:
                    cancels = self._cancelled
                    self._cancelled = set()
                for req in pending:  # still queued: drop before admission
                    if req.uid in cancels:
                        req.cancelled = True
                        req.done = True
                        self._inflight.append(req)  # event set below
                pending = [r for r in pending if not r.done]
                for uid in cancels:  # in-flight: free the slot
                    self.sched.cancel(uid)
            try:
                if pending:
                    admitted = pending[:self.sched.admit(pending)]
                    pending = pending[len(admitted):]
                    self._inflight = self._inflight + admitted
                if self.sched.active.any():
                    self.sched.step(waiting=len(pending))
                else:
                    self._stop.wait(self._poll)
            except Exception as exc:  # noqa: BLE001 — worker must survive
                logger.exception("scheduler worker error — failing %d "
                                 "in-flight request(s), loop continues",
                                 len(self._inflight) + len(pending))
                for req in self._inflight + pending:
                    req.error = str(exc)
                    req.done = True
                pending = []
                # free any slots (and cache resources) the failed batch held
                if hasattr(self.sched, "fail_all"):
                    self.sched.fail_all()
                else:  # duck-typed test schedulers
                    for slot, req in enumerate(self.sched.slot_req):
                        if req is not None:
                            self.sched.slot_req[slot] = None
                    self.sched.active[:] = False
            # signal finished requests (event set once, permanently)
            still = []
            for req in self._inflight:
                if req.done:
                    ev = self._events.get(req.uid)
                    if ev is not None:
                        ev.set()
                else:
                    still.append(req)
            self._inflight = still

    def stream_tokens(self, req: Request, poll: float = 0.01,
                      timeout: float = 300.0):
        """Submit `req` and yield its token ids as the scheduler emits them
        (the worker thread appends to req.output_ids; this generator tails
        it). The request shares decode ticks with all other slots — unlike
        engine.stream, which owns the device. Closing the generator early
        (client disconnect) or exceeding `timeout` cancels the request so
        its slot is freed."""
        self.submit(req)
        sent = 0
        deadline = time.monotonic() + timeout
        try:
            while True:
                n = len(req.output_ids)
                while sent < n:
                    yield req.output_ids[sent]
                    sent += 1
                if req.done and sent == len(req.output_ids):
                    return
                if time.monotonic() > deadline:
                    self.cancel(req.uid)
                    return
                time.sleep(poll)
        finally:
            if not req.done:
                self.cancel(req.uid)
            self._events.pop(req.uid, None)

    def await_request(self, req: Request, timeout: float = 300.0):
        """Submit and block until done/timeout; returns the result dict."""
        self.submit(req)
        deadline = time.monotonic() + timeout
        while not req.done and time.monotonic() < deadline:
            ev = self._events[req.uid]
            ev.wait(0.05)
        if not req.done:
            # timed out: cancel so the slot stops burning decode compute
            self.cancel(req.uid)
        self._events.pop(req.uid, None)
        text = self.tokenizer.decode(req.output_ids,
                                     skip_special_tokens=True)
        if req.error is not None:
            reason = "error"
        elif req.cancelled:
            reason = "cancelled"
        elif req.done:
            reason = "stop"
        else:
            reason = "timeout"
        out = {"text": text, "tokens": req.output_ids,
               "finish_reason": reason}
        if req.error is not None:
            out["error"] = req.error
        return out

    def generate_blocking(self, prompt: str, image: Optional[np.ndarray],
                          max_new_tokens: int, timeout: float = 300.0,
                          temperature: Optional[float] = None,
                          top_p: Optional[float] = None):
        req = self.build_request(prompt, image, max_new_tokens,
                                 temperature=temperature, top_p=top_p)
        return self.await_request(req, timeout)


def make_handler(frontend: ServingFrontend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", **frontend.stats()})
            elif self.path == "/stats":
                body = {"status": "ok", **frontend.stats()}
                pool = getattr(frontend.sched, "pool_stats", None)
                if callable(pool):  # paged scheduler: pool + prefix cache
                    body["pool"] = pool()
                self._send(200, body)
            else:
                self._send(404, {"error": "not found"})

        def _parse_body(self):
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            prompt = payload["prompt"]
            image = None
            if payload.get("images_b64"):  # multi-image prompt
                image = [decode_b64(b) for b in payload["images_b64"]]
            elif payload.get("image_b64"):
                image = decode_b64(payload["image_b64"])
            temp = payload.get("temperature")
            top_p = payload.get("top_p")
            return (prompt, image, int(payload.get("max_new_tokens", 128)),
                    None if temp is None else float(temp),
                    None if top_p is None else float(top_p))

        def _stream(self, prompt, image, max_new_tokens,
                    temperature, top_p):
            """newline-delimited JSON: one {"token", "text_delta"} object
            per emitted token, then a final {"done": true} record. A client
            disconnect cancels the request (its slot frees mid-stream)."""
            req = frontend.build_request(prompt, image, max_new_tokens,
                                         temperature=temperature,
                                         top_p=top_p)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            decoded = ""
            ids = []
            try:
                for tok in frontend.stream_tokens(req):
                    ids.append(tok)
                    full = frontend.tokenizer.decode(
                        ids, skip_special_tokens=True)
                    delta, decoded = full[len(decoded):], full
                    self.wfile.write(json.dumps(
                        {"token": tok, "text_delta": delta}).encode()
                        + b"\n")
                    self.wfile.flush()
                reason = ("error" if req.error is not None else
                          "cancelled" if req.cancelled else "stop")
                self.wfile.write(json.dumps(
                    {"done": True, "finish_reason": reason,
                     "text": decoded}).encode() + b"\n")
            except (BrokenPipeError, ConnectionResetError):
                frontend.cancel(req.uid)

        def _chat_completions(self):
            """OpenAI-compatible /v1/chat/completions: messages in (string
            or vision content parts with data: image URLs), completion or
            SSE stream out."""
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            temp = payload.get("temperature")
            top_p = payload.get("top_p")
            req = frontend.build_chat_request(
                payload["messages"],
                int(payload.get("max_tokens",
                                payload.get("max_completion_tokens", 128))),
                temperature=None if temp is None else float(temp),
                top_p=None if top_p is None else float(top_p))
            model = payload.get("model", "lhrs-bot-tpu")
            cid = f"chatcmpl-{req.uid}"
            n_prompt = int(len(req.input_ids))

            if payload.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def sse(obj):
                    self.wfile.write(b"data: " + json.dumps(obj).encode()
                                     + b"\n\n")
                    self.wfile.flush()

                decoded = ""
                ids = []
                try:
                    sse({"id": cid, "object": "chat.completion.chunk",
                         "model": model,
                         "choices": [{"index": 0, "delta":
                                      {"role": "assistant"},
                                      "finish_reason": None}]})
                    for tok in frontend.stream_tokens(req):
                        ids.append(tok)
                        full = frontend.tokenizer.decode(
                            ids, skip_special_tokens=True)
                        delta, decoded = full[len(decoded):], full
                        sse({"id": cid,
                             "object": "chat.completion.chunk",
                             "model": model,
                             "choices": [{"index": 0,
                                          "delta": {"content": delta},
                                          "finish_reason": None}]})
                    reason = ("stop" if req.done and not req.cancelled
                              and req.error is None else "length")
                    sse({"id": cid, "object": "chat.completion.chunk",
                         "model": model,
                         "choices": [{"index": 0, "delta": {},
                                      "finish_reason": reason}]})
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    frontend.cancel(req.uid)
                return

            result = frontend.await_request(req)
            reason = {"stop": "stop", "timeout": "length"}.get(
                result["finish_reason"], result["finish_reason"])
            self._send(200, {
                "id": cid, "object": "chat.completion", "model": model,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": result["text"]},
                             "finish_reason": reason}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": len(result["tokens"]),
                          "total_tokens": n_prompt
                          + len(result["tokens"])}})

        def do_POST(self):
            routes = ("/generate", "/generate_stream",
                      "/v1/chat/completions")
            if self.path not in routes:
                self._send(404, {"error": "not found"})
                return
            try:
                if self.path == "/v1/chat/completions":
                    self._chat_completions()
                    return
                prompt, image, max_new, temp, top_p = self._parse_body()
                if self.path == "/generate_stream":
                    self._stream(prompt, image, max_new, temp, top_p)
                    return
                result = frontend.generate_blocking(
                    prompt, image, max_new, temperature=temp, top_p=top_p)
                self._send(200, result)
            except (KeyError, ValueError, json.JSONDecodeError) as exc:
                self._send(400, {"error": f"bad request: {exc}"})
            except Exception as exc:  # noqa: BLE001
                logger.exception("generate failed")
                self._send(500, {"error": str(exc)})

    return Handler


def serve(frontend: ServingFrontend, port: int = 8000):
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(frontend))
    logger.info("serving API on :%d (POST /generate, /generate_stream, "
                "/v1/chat/completions; GET /health, /stats)", port)
    server.serve_forever()
