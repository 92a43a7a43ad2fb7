"""RAG serving on the PyTorch/CUDA port: d-HNSW as the retrieval tier
for an LM (paper §1).

    python examples/torch_rag_serve.py [--arch qwen3-8b] [--device cuda|cpu]

The twin of ``examples/rag_serve.py`` through ``repro_torch``: the same
CLI, steps and printed lines.  A batch of prompts is embedded, d-HNSW
retrieves the closest document vectors (meta-route -> doorbell fetch ->
sub-search), the docs' tokens are prepended, and the LM (any of the 10
assigned architectures, reduced to a small config) prefills +
greedy-decodes.  On the card the decode attention runs the hand-written
``decode_attention`` kernel.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.registry import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.core import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.serve.engine import (RagServeEngine,  # noqa: E402
                                      synthetic_doc_store)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_IDS)
    ap.add_argument("--n-docs", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    print(f"arch: {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model})")

    print(f"indexing {args.n_docs} docs in d-HNSW...")
    docs = synthetic_doc_store(args.n_docs, 64, doc_len=8,
                               vocab=cfg.vocab_size)
    retriever = DHNSWEngine(EngineConfig(
        mode="full", search_mode="scan", n_rep=64, b=2, ef=32,
        cache_frac=0.15), device=args.device).build(docs.embeddings)

    with RagServeEngine(cfg, retriever, docs, max_new_tokens=8,
                        docs_per_query=2, device=args.device) as engine:
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, 12)).astype(np.int32)
        print(f"serving batch of {args.batch} prompts...")
        out, st = engine.serve(prompts)
    print(f"  retrieval: {st.retrieve_s*1e3:.1f} ms "
          f"({st.retrieval['n_fetches']} partition fetches, "
          f"{st.retrieval['round_trips_per_query']:.3f} trips/query)")
    print(f"  prefill:   {st.prefill_s*1e3:.1f} ms")
    print(f"  decode:    {st.decode_s*1e3:.1f} ms "
          f"({out.shape[1]} tokens/seq)")
    print(f"  generated token ids, first sequence: {out[0].tolist()}")


if __name__ == "__main__":
    main()
