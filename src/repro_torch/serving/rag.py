"""RAG serving pipeline — the paper's motivating deployment (§1).

Counterpart of ``repro/serving/rag.py``.  Documents are embedded into the
vector index; a query retrieves the top-k nearest documents and their token
chunks are prepended to the prompt served by the LM tenant.  Retrieval
routes through a ``repro_torch.api.Deployment``, so the RAG tenant composes
with any engine (baton / scatter-gather / exact) and search route the
service layer can express — on the card, the baton engine's kernel route.
:meth:`RAGSystem.serve_retrieval` runs the query stream through the
executable tier's workers (answers stay bit-identical to
:meth:`RAGSystem.retrieve`; only latency becomes real).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import (
    DataSpec, Deployment, IndexSpec, SearchParams, ServeConfig, get_engine,
)
from repro_torch.device import timed
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving import decode


@dataclasses.dataclass
class RAGSystem:
    deployment: Deployment         # retrieval tier (engine + index + params)
    doc_tokens: np.ndarray         # (N_docs, chunk_len) int32
    lm_cfg: ModelConfig
    lm_params: T.Params

    @property
    def index(self):
        return self.deployment.index

    @property
    def search_cfg(self):
        return self.deployment.config.search

    def retrieve(self, query_embs: np.ndarray):
        """(B, d) query embeddings -> (ids, dists, stats)."""
        res = self.deployment.search(query_embs)
        return res.ids, res.dists, res.stats

    def serve_retrieval(self, query_embs: np.ndarray, workers: int = 2,
                        mode: str = "thread"):
        """Concurrent retrieval on the executable tier (baton engine only).

        Same (ids, dists) as :meth:`retrieve` — the tier's parity guarantee
        — but served by ``workers`` partition-owning workers (threads, or
        processes with ``mode="process"``), so the returned
        ``ExecRunResult`` carries measured per-query latency.
        """
        from repro_torch.serve_async import AsyncServingTier

        dep = self.deployment
        with AsyncServingTier(
                dep.index, dep.engine.baton_params(dep.config.search),
                n_workers=workers, mode=mode) as tier:
            return tier.search(np.asarray(query_embs, np.float32))

    def answer(self, query_embs: np.ndarray, prompt_tokens: np.ndarray,
               max_new: int = 16, timings: "dict | None" = None):
        """Retrieve k doc chunks per query, prepend, generate on the LM's
        device.  Returns ((B, max_new) int32 tokens, ids, stats);
        ``timings`` (if given) receives the wall seconds of ``retrieve``,
        ``prefill`` and ``decode``."""
        dev = self.lm_params.embed.device
        with timed(timings, "retrieve", dev):
            ids, _, stats = self.retrieve(query_embs)
        b = query_embs.shape[0]
        k = min(2, ids.shape[1])
        ctx_tokens = self.doc_tokens[np.clip(ids[:, :k], 0, None)]
        ctx_tokens = ctx_tokens.reshape(b, -1)
        full = np.concatenate([ctx_tokens, prompt_tokens], axis=1)
        full = np.mod(full, self.lm_cfg.vocab_size).astype(np.int32)
        out = decode.generate(
            self.lm_cfg, self.lm_params, torch.from_numpy(full).to(dev),
            max_new=max_new, timings=timings)
        return out.cpu().numpy(), ids, stats


def build_demo(n_docs: int = 2000, d: int = 64, p: int = 4, seed: int = 0,
               lm_cfg: ModelConfig | None = None, device="cuda"):
    """Small end-to-end RAG system over synthetic docs (examples + tests).

    The numpy draws are the reference's, in its order, so for a seed the
    doc embeddings and ``doc_tokens`` equal the reference's; the index is
    the port's own vamana build, the LM's weights a seeded
    ``torch.Generator``'s."""
    from repro_torch.configs.registry import get_smoke_config

    rng = np.random.default_rng(seed)
    doc_embs = rng.normal(size=(n_docs, d)).astype(np.float32)
    cfg = ServeConfig(
        name="rag-demo",
        data=DataSpec(n=n_docs, n_queries=0, seed=seed),
        index=IndexSpec(engine="baton", p=p, graph_mode="vamana", r=16,
                        l_build=32, pq_m=16, pq_k=64, head_fraction=0.02,
                        seed=seed),
        search=SearchParams(L=32, W=4, k=10, pool=128, slots=16),
    )
    engine = get_engine(cfg.index.engine, device=device)
    engine.build(doc_embs, cfg.index)
    deployment = Deployment.from_parts(cfg, engine)
    lm_cfg = lm_cfg or get_smoke_config("qwen2-0.5b")
    lm_params = T.init_params(lm_cfg, seed=seed, device=device)
    doc_tokens = rng.integers(
        0, lm_cfg.vocab_size, size=(n_docs, 8)
    ).astype(np.int32)
    return RAGSystem(
        deployment=deployment,
        doc_tokens=doc_tokens, lm_cfg=lm_cfg, lm_params=lm_params,
    )
