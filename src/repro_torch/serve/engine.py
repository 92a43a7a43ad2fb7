"""Serving engine: batched LM inference with d-HNSW retrieval (RAG), on
torch.

Port of ``repro/serve/engine.py``.  The paper positions d-HNSW as the
retrieval tier for LLM/RAG serving (§1); this engine is that
integration: a request batch is embedded, the d-HNSW engine retrieves
top-k document vectors (meta-HNSW routing in the compute pool, doorbell
fetches from the memory pool), and the retrieved documents' tokens are
prepended to each prompt before a prefill + greedy decode (any family
but ``encdec``, whose prefill needs frames the engine does not pass, as
in the reference; see ``models/model.py``).

Embedding is the LM's own token-embedding mean (standard cheap query
encoder for tests/examples; any encoder slots in via ``embed_fn``).

The weights are drawn from a seeded ``torch.Generator`` on the engine's
device, one tensor at a time; the matrices are kept in the compute dtype
and the embedding table and norm scales in f32 (``models.model.
stored_dtype``).  Everything runs on ``device``: ``"cuda"`` unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import DHNSWEngine, resolve_device
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.serve.server import SearchServer

# the ``torch.profiler`` range around the decode loop (its device work
# included), which a profile of ``serve`` reads the decode window from
DECODE_SPAN = "serve.decode"


@dataclass
class DocStore:
    """Document corpus: embedding per doc (indexed by d-HNSW) + tokens."""

    embeddings: np.ndarray          # (n_docs, D)
    tokens: np.ndarray              # (n_docs, doc_len) i32


@dataclass
class ServeStats:
    retrieve_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    retrieval: dict = field(default_factory=dict)


class RagServeEngine:
    """build -> serve(prompts) -> generated tokens.

    Retrieval goes through a ``SearchServer`` (micro-batching tier), so
    concurrent ``serve`` callers — or any other client of the same server
    — coalesce into fused d-HNSW batches.  Passing a bare ``DHNSWEngine``
    wraps it in a private server.
    """

    def __init__(self, cfg: ModelConfig,
                 retriever: "DHNSWEngine | SearchServer",
                 docs: DocStore, *, max_new_tokens: int = 16,
                 docs_per_query: int = 2,
                 embed_fn: Optional[Callable] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._own_server = not isinstance(retriever, SearchServer)
        self.server = (SearchServer(retriever) if self._own_server
                       else retriever)
        self.retriever = self.server.engine
        self.docs = docs
        self.max_new_tokens = max_new_tokens
        self.docs_per_query = docs_per_query
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(
            M.param_defs(cfg), gen,
            cast=lambda name, t: t.to(M.stored_dtype(cfg, name)))
        self._embed_fn = embed_fn

    def close(self):
        """Stop the private batcher thread (no-op for an adopted server)."""
        if self._own_server:
            self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _embed(self, tokens: np.ndarray) -> np.ndarray:
        # a method, not a bound method kept on the instance: that would be
        # a reference cycle, and the weights would outlive the last
        # reference until the garbage collector ran
        return (self._embed_fn or self._default_embed)(tokens)

    def _default_embed(self, tokens: np.ndarray) -> np.ndarray:
        emb = self.params["embed"]  # f32, on the device
        idx = torch.as_tensor(np.clip(tokens, 0, emb.shape[0] - 1),
                              device=emb.device)
        # the rows are gathered on the device; the mean is numpy's, as in
        # the reference, so both packages embed a prompt to the same bits
        e = emb[idx].cpu().numpy().mean(axis=1)
        d = self.docs.embeddings.shape[1]
        if e.shape[1] >= d:
            return e[:, :d].astype(np.float32)
        return np.pad(e, ((0, 0), (0, d - e.shape[1]))).astype(np.float32)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, prompts: np.ndarray) -> tuple[np.ndarray, ServeStats]:
        """prompts (B, S_p) i32 -> (generated (B, max_new_tokens), stats)."""
        stats = ServeStats()
        B, Sp = prompts.shape

        # 1. retrieve through the micro-batching tier (the paper's tier:
        # batched, deduped, doorbell'd — fused across concurrent callers)
        t0 = time.perf_counter()
        q = self._embed(prompts)
        _, doc_ids, rstats = self.server.search(q, k=self.docs_per_query)
        stats.retrieval = rstats
        stats.retrieve_s = time.perf_counter() - t0

        # 2. prepend retrieved doc tokens (pad docs that returned -1)
        doc_len = self.docs.tokens.shape[1]
        ctx = np.zeros((B, self.docs_per_query * doc_len), np.int32)
        for i in range(B):
            for j in range(self.docs_per_query):
                d = int(doc_ids[i, j])
                if 0 <= d < len(self.docs.tokens):
                    ctx[i, j * doc_len:(j + 1) * doc_len] = self.docs.tokens[d]
        tokens = np.concatenate([ctx, prompts], axis=1)
        S = tokens.shape[1]
        cache_len = S + self.max_new_tokens

        # 3. prefill + greedy decode
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = M.prefill(
                self.cfg, self.params,
                {"tokens": torch.as_tensor(tokens, device=self.device)},
                cache_len)
            self._sync()
            stats.prefill_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            with torch.profiler.record_function(DECODE_SPAN):
                out = np.zeros((B, self.max_new_tokens), np.int32)
                # argmax takes the first maximal index, as jnp.argmax does
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                pos = torch.full((B,), S, dtype=torch.int32,
                                 device=self.device)
                for t in range(self.max_new_tokens):
                    out[:, t] = tok.cpu().numpy()
                    logits, cache = M.decode_step(self.cfg, self.params,
                                                  cache, tok, pos)
                    tok = torch.argmax(logits, dim=-1).to(
                        torch.int32).reshape(B)
                    pos = pos + 1
                self._sync()
        stats.decode_s = time.perf_counter() - t0
        return out, stats


def synthetic_doc_store(n_docs: int, dim: int, doc_len: int,
                        vocab: int, seed: int = 0) -> DocStore:
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, dim)).astype(np.float32)
    toks = rng.integers(0, vocab, (n_docs, doc_len)).astype(np.int32)
    return DocStore(emb, toks)
