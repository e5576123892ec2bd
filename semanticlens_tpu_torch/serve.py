"""Concept-search serving: query a built concept DB as a long-lived service.

Counterpart of ``semanticlens_tpu.serve``: :class:`SearchService` wraps a
foundation model and an aggregated concept DB, and :func:`serve` exposes it
over plain HTTP (stdlib ``http.server``). Endpoints, JSON bodies and status
codes are the JAX package's:

- ``GET /healthz`` → ``{"ok": true, "layers": [...]}``
- ``GET /text_search?q=dog&k=5`` → per-layer top-k component ids and scores
- ``GET /label?words=dog,cat&top_m=3&max_components=64`` → per-component
  vocabulary labels (:func:`semanticlens_tpu_torch.lens.label_components`)
- ``POST /image_search?k=5`` with an image file as the body → the same as
  text search for that image. The body decodes at full resolution to PIL's
  RGB array, its format (JPEG, PNG, BMP or WebP) chosen by its content
  (``data/image_decode.py``: nvJPEG on the card and libjpeg on the CPU for
  JPEGs), on the service's device thread, where the decoder's nvJPEG handle
  lives. A body no decoder reads (another format, corrupt, truncated or
  oversized) is a 400; the JAX server decodes with PIL and answers a body it
  cannot decode with 500.

Each query is embedded, then held against every layer's bank by kernel K1
(one launch per layer: the streaming kernel for one query), then a stable
descending sort gives the top k — the same ids and scores as offline
probing, for any k. The JAX package's fused XLA programs only avoid
recompiles and have no counterpart here. The device work of every request
runs on one long-lived thread of the service: PyTorch keeps per-thread
state (cuDNN's attention plans among it) that each new request thread of
the HTTP server would otherwise build again.

Run as ``python -m semanticlens_tpu_torch.serve --db concept_db-….safetensors``
(see :func:`main`).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from semanticlens_tpu_torch.data import image_decode, native_decoder
from semanticlens_tpu_torch.lens import _embed_vocabulary, _encode_text_chunked, label_components
from semanticlens_tpu_torch.scores import _cosine_matrix

logger = logging.getLogger(__name__)

# Largest accepted POST body.
MAX_BODY_BYTES = 16 * 1024 * 1024


class _BadRequest(ValueError):
    """Client input error — rendered as HTTP 400, not 500."""


class SearchService:
    """Warm query service over an aggregated concept DB.

    Parameters
    ----------
    fm : foundation model with ``tokenize`` / ``encode_text`` (and
        ``preprocess`` / ``encode_image`` for image queries) and ``device``.
    aggregated_db : ``{layer: (n_components, D)}`` — the mean-aggregated
        concept DB (``concept_db.mean(1)``).
    templates : prompt templates for text queries, with the same
        empty-template bias correction as ``Lens.text_probing``.
    warmup : run one text (and image) query at construction, so the kernel
        build and the towers' first use happen before any request; on the
        card the nvJPEG decoder for uploads is made then too.
    """

    # Distinct vocabularies whose embeddings stay cached (FIFO).
    VOCAB_CACHE_ENTRIES = 8

    def __init__(self, fm, aggregated_db: dict, *, templates=None, warmup: bool = True):
        self.fm = fm
        self.templates = templates
        self.banks = {k: np.asarray(v, np.float32) for k, v in aggregated_db.items()}
        if not self.banks:
            raise ValueError("aggregated_db must contain at least one layer")
        self.device = torch.device(fm.device)
        # ThreadingHTTPServer runs each request on its own thread: the vocab
        # cache is guarded by this lock.
        self._lock = threading.Lock()
        self._vocab_cache: dict = {}
        self._device_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="search-device")
        self._jpeg_decoder = None  # made on the device thread (at warm-up on the card)
        self._banks_dev = {k: torch.as_tensor(v, device=self.device) for k, v in self.banks.items()}
        # The empty-template embeddings are a constant of the service.
        self._empty_emb = None
        if templates:
            with torch.inference_mode():
                self._empty_emb = _encode_text_chunked(fm, [t.format("") for t in templates], None)
        if warmup:
            # The first K1 launch builds csrc/cosine.cu: that belongs to start-up, not to a request.
            logger.info("warming text search...")
            self.text_search("warmup", k=1)
            if hasattr(fm, "encode_image") and hasattr(fm, "preprocess"):
                logger.info("warming image search...")
                try:
                    self.image_search(np.zeros((32, 32, 3), np.uint8), k=1)
                except Exception:  # FM without a usable image tower — text-only service
                    logger.warning("image-search warmup failed; image queries disabled cold", exc_info=True)
                if self.device.type == "cuda":
                    self._on_device_thread(self._nvjpeg)
            logger.info("search service ready (%d layers)", len(self.banks))

    def _on_device_thread(self, fn, *args):
        """Run ``fn(*args)`` on the service's device thread under inference mode (thread-local)."""

        def call():
            with torch.inference_mode():
                return fn(*args)

        return self._device_thread.submit(call).result()

    def close(self):
        """Stop the device thread once the requests in flight are done."""
        self._device_thread.shutdown()

    def _bank_topk(self, q: torch.Tensor, k: int) -> dict:
        """(1, D) query → per-layer top-k ids and scores (K1, then a stable sort)."""
        out = {}
        for layer, bank in self._banks_dev.items():
            sim = _cosine_matrix(q.to(self.device, torch.float32), bank)[0]
            vals, idx = torch.sort(sim, descending=True, stable=True)
            kk = min(k, bank.shape[0])
            out[layer] = {
                "ids": idx[:kk].tolist(),
                "scores": [round(float(v), 6) for v in vals[:kk].tolist()],
            }
        return out

    def text_search(self, query: str, k: int = 5) -> dict:
        """Top-k components per layer for a natural-language query."""
        return self._on_device_thread(self._text_search, query, k)

    def _text_search(self, query: str, k: int) -> dict:
        texts = [t.format(query) for t in self.templates] if self.templates else [query]
        emb = self.fm.encode_text(self.fm.tokenize(texts)).float()
        q = (emb - self._empty_emb).mean(0, keepdim=True) if self._empty_emb is not None else emb
        return self._bank_topk(q, k)

    def image_search(self, image: np.ndarray, k: int = 5) -> dict:
        """Top-k components per layer for an image query (H, W, 3 uint8)."""
        return self._on_device_thread(self._image_search, image, k)

    def _image_search(self, image, k: int) -> dict:
        q = self.fm.encode_image(self.fm.preprocess(image[None])).float()
        return self._bank_topk(q, k)

    def image_file_search(self, data: bytes, k: int = 5) -> dict:
        """Top-k components per layer for an image file's bytes (JPEG, PNG or BMP, told apart by content),
        decoded at full resolution to RGB.

        Raises :class:`~semanticlens_tpu_torch.data.raw.DecodeError` for bytes no decoder reads.
        """
        return self._on_device_thread(self._image_file_search, data, k)

    def _nvjpeg(self) -> native_decoder.NvJpegDecoder:
        """The device thread's nvJPEG decoder (made at first use)."""
        if self._jpeg_decoder is None:
            self._jpeg_decoder = native_decoder.NvJpegDecoder(self.device)
        return self._jpeg_decoder

    def _image_file_search(self, data: bytes, k: int) -> dict:
        decoder = self._nvjpeg() if self.device.type == "cuda" else None
        image = image_decode.decode(data, "request body", self.device, nvjpeg=decoder)
        return self._image_search(image, k)

    def _vocab_embeds(self, vocabulary: list[str]) -> torch.Tensor:
        """Embed a vocabulary once per (words, templates); repeated /label requests reuse it."""
        key = (tuple(vocabulary), tuple(self.templates) if self.templates else None)
        with self._lock:
            hit = self._vocab_cache.get(key)
        if hit is not None:
            return hit
        embeds = _embed_vocabulary(self.fm, list(vocabulary), self.templates, 1024)
        with self._lock:
            while len(self._vocab_cache) >= self.VOCAB_CACHE_ENTRIES:
                self._vocab_cache.pop(next(iter(self._vocab_cache)))
            self._vocab_cache[key] = embeds
        return embeds

    def label(self, vocabulary: list[str], top_m: int = 3, max_components: int = 64) -> dict:
        """Per-component vocabulary labels for the first ``max_components``."""
        head = {k: v[:max_components] for k, v in self.banks.items()}
        named = self._on_device_thread(
            lambda: label_components(self.fm, vocabulary, head, top_m=top_m, templates=self.templates,
                                     vocab_embeds=self._vocab_embeds(list(vocabulary))))
        return {
            layer: [
                {"component": i, "words": words[i], "scores": [round(float(v), 6) for v in vals[i]]}
                for i in range(len(words))
            ]
            for layer, (words, vals) in named.items()
        }


class _Handler(BaseHTTPRequestHandler):
    service: SearchService  # set by serve()

    def log_message(self, fmt, *args):  # route through the package logger
        logger.debug("http: " + fmt, *args)

    def _json(self, payload, status=200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _int_param(self, qs, name: str, default: int) -> int:
        """Positive-int query param; raises _BadRequest (→ 400) on junk."""
        raw = qs.get(name, [str(default)])[0]
        try:
            value = int(raw)
        except ValueError:
            raise _BadRequest(f"{name} must be an integer, got {raw!r}") from None
        if value < 1:
            raise _BadRequest(f"{name} must be >= 1, got {value}")
        return value

    def do_GET(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        try:
            if url.path == "/healthz":
                self._json({"ok": True, "layers": sorted(self.service.banks)})
            elif url.path == "/text_search":
                query = qs.get("q", [""])[0]
                if not query:
                    self._json({"error": "missing q parameter"}, 400)
                    return
                k = self._int_param(qs, "k", 5)
                self._json({"query": query, "results": self.service.text_search(query, k)})
            elif url.path == "/label":
                words = [w for w in qs.get("words", [""])[0].split(",") if w]
                if not words:
                    self._json({"error": "missing words parameter"}, 400)
                    return
                top_m = self._int_param(qs, "top_m", 3)
                max_components = self._int_param(qs, "max_components", 64)
                n_total = max(v.shape[0] for v in self.service.banks.values())
                self._json({
                    "results": self.service.label(words, top_m, max_components),
                    "truncated": n_total > max_components,
                    "max_components": max_components,
                })
            else:
                self._json({"error": f"unknown path {url.path}"}, 404)
        except _BadRequest as exc:
            self._json({"error": str(exc)}, 400)
        except Exception as exc:  # pragma: no cover — defensive: keep serving
            logger.exception("request failed")
            self._json({"error": f"{type(exc).__name__}: {exc}"}, 500)

    def do_POST(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        if url.path != "/image_search":
            self._json({"error": f"unknown path {url.path}"}, 404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._json({"error": "bad Content-Length header"}, 400)
            return
        if not length:
            self._json({"error": "missing request body (image file bytes)"}, 400)
            return
        if length > MAX_BODY_BYTES:
            # Refused before reading: a client's Content-Length must not drive the allocation.
            self._json({"error": f"request body {length} exceeds cap {MAX_BODY_BYTES}"}, 413)
            return
        raw = self.rfile.read(length)
        try:
            k = self._int_param(qs, "k", 5)
            self._json({"results": self.service.image_file_search(raw, k)})
        except (_BadRequest, image_decode.DecodeError) as exc:  # bad k, or a body no decoder reads
            self._json({"error": str(exc)}, 400)
        except Exception as exc:  # pragma: no cover — defensive: keep serving
            logger.exception("request failed")
            self._json({"error": f"{type(exc).__name__}: {exc}"}, 500)


def serve(service: SearchService, port: int = 0, *, background: bool = False):
    """Run the HTTP server on 127.0.0.1. Returns ``(server, thread | None)``.

    ``port=0`` binds an ephemeral port (``server.server_address[1]``);
    ``background=True`` serves from a daemon thread.
    """
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    logger.info("serving concept search on port %d", server.server_address[1])
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread
    server.serve_forever()
    return server, None


def load_aggregated_db(path) -> dict[str, np.ndarray]:
    """A ``concept_db-*.safetensors`` as ``{layer: (C, D) float32}``; (C, k, D) tables are mean-aggregated."""
    from semanticlens_tpu_torch.utils import safetensors_io

    raw = {k: v.float().numpy() for k, v in safetensors_io.load_file(path).items()}
    return {k: v.mean(1) if v.ndim == 3 else v for k, v in raw.items()}


def build_foundation_model(name: str, *, checkpoint=None, bpe=None, device=None):
    """The query FM for ``--fm``, bf16, through ``foundation_models.create``: an OpenCLIP preset
    (ViT or RN), ``siglip2`` or ``mobileclip-s1``/``-s2``. ``bpe`` is the CLIP BPE file, or for SigLIP
    the SentencePiece ``.model``."""
    from semanticlens_tpu_torch.foundation_models import create

    return create(name, checkpoint=checkpoint, bpe_path=bpe, tokenizer_path=bpe, dtype=torch.bfloat16,
                  device=device)


def main(argv=None):
    """``python -m semanticlens_tpu_torch.serve --db … [--fm ViT-B-32] [--checkpoint …] [--bpe …]
    [--port 8080] [--templates "a photo of a {}"] [--device cuda]``."""
    ap = argparse.ArgumentParser(description="Serve a concept DB for text search and labeling over HTTP.")
    ap.add_argument("--db", required=True, help="concept_db-*.safetensors from Lens.compute_concept_db")
    ap.add_argument("--fm", default="ViT-B-32", help="OpenCLIP preset, siglip2, mobileclip-s1 or mobileclip-s2")
    ap.add_argument("--checkpoint", default=None, help="FM weights (.safetensors or .npz)")
    ap.add_argument("--bpe", default=None, help="CLIP BPE merges file, or SigLIP's SentencePiece .model")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--templates", nargs="*", default=["a photo of a {}"])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    agg = load_aggregated_db(args.db)
    fm = build_foundation_model(args.fm, checkpoint=args.checkpoint, bpe=args.bpe, device=args.device)
    serve(SearchService(fm, agg, templates=args.templates or None), args.port)


if __name__ == "__main__":
    main()
