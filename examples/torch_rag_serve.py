"""End-to-end serving driver on the PyTorch/CUDA port (the paper's kind:
serve batched requests).

    PYTHONPATH=src python examples/torch_rag_serve.py [--device cpu]

The port's counterpart of ``examples/rag_serve.py``.  A RAG pipeline:
BatANN retrieves document chunks from the distributed disk-based index; a
small LM tenant (qwen2 at smoke size) generates continuations conditioned on
the retrieved context -- the deployment that motivates the paper (section 1).
``serving/rag.py::build_demo`` builds 2000 synthetic docs (d = 64) into a
4-server baton index; retrieval routes through the system's
``Deployment``, here on the baton engine's kernel route
(``adc_impl="mxu_tiled"``, ``merge_impl="bitonic"``): on the card the
slot-ADC and top-k CUDA kernels answer every retrieval step.  8 requests
(queries near known documents, 4 prompt tokens each) are served with
``max_new=8``.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the host with the kernels' plain versions.  Prints the
reference's lines plus the wall seconds of retrieval, prefill and decode
on the device; ``main`` returns the answers (tokens, retrieved ids,
counters), the requests and the system as a dict.  ``--n-docs`` and
``--d`` shrink the demo (the tests build ``--n-docs 400 --d 32``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.api import Deployment
from repro_torch.device import resolve_device
from repro_torch.serving import rag

# the baton engine's kernel route (slot ADC + bitonic top-k on the card)
KERNEL_ROUTE = {"adc_impl": "mxu_tiled", "merge_impl": "bitonic"}


def on_kernel_route(system: rag.RAGSystem) -> rag.RAGSystem:
    """The same system, retrieving on the baton engine's kernel route."""
    dep = system.deployment
    return dataclasses.replace(system, deployment=Deployment.from_parts(
        dep.config.with_updates(search=KERNEL_ROUTE), dep.engine,
        dataset=dep.dataset, cost=dep.cost))


def requests(system, n_requests: int = 8):
    """The reference example's batch: ``n_requests`` queries near known
    documents (each a doc vector plus 0.05 noise) and 4 random prompt tokens
    each, drawn in its order from its seed.  Returns (targets, queries,
    prompts)."""
    rng = np.random.default_rng(7)
    idx = system.index
    n2p, n2l = idx.node2part.cpu().numpy(), idx.node2local.cpu().numpy()
    doc_vecs = idx.part_vectors.cpu().numpy()[n2p, n2l]
    d = doc_vecs.shape[1]
    targets = rng.integers(0, len(n2p), size=n_requests)
    queries = doc_vecs[targets] + 0.05 * rng.normal(
        size=(n_requests, d)).astype(np.float32)
    prompts = rng.integers(0, system.lm_cfg.vocab_size,
                           size=(n_requests, 4)).astype(np.int32)
    return targets, queries, prompts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-docs", type=int, default=2000)
    ap.add_argument("--d", type=int, default=64)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"== building RAG system: {args.n_docs} docs, 4-server BatANN "
          f"index, smoke-scale qwen2 generator ({dev.type}) ==")
    t0 = time.perf_counter()
    system = on_kernel_route(rag.build_demo(n_docs=args.n_docs, d=args.d,
                                            p=4, seed=0, device=dev))
    build_s = time.perf_counter() - t0
    print(f"built in {build_s:.0f}s")

    targets, queries, prompts = requests(system)
    timings: dict = {}
    t0 = time.perf_counter()
    tokens, retrieved, stats = system.answer(queries, prompts, max_new=8,
                                             timings=timings)
    dt = time.perf_counter() - t0
    hit = float((retrieved[:, 0] == targets).mean())
    print(f"\nserved {len(queries)} requests in {dt:.1f}s "
          f"({system.deployment.engine.name} retrieval engine)")
    print(f"retrieval rank-1 hit rate : {hit:.0%}")
    print(f"retrieval hops/query      : {stats['hops'].mean():.1f} "
          f"(inter-partition {stats['inter_hops'].mean():.2f})")
    print(f"generated tokens shape    : {tokens.shape}")
    print(f"sample continuation ids   : {tokens[0].tolist()}")
    print(f"device wall time          : retrieve "
          f"{timings['retrieve']:.3f} s, prefill {timings['prefill']:.3f} s, "
          f"decode {timings['decode']:.3f} s on {dev.type}")
    return {"tokens": tokens, "ids": retrieved, "stats": stats,
            "hit_rate": hit, "targets": targets, "queries": queries,
            "prompts": prompts, "wall_s": dt, "timings": timings,
            "build_s": build_s, "system": system}


if __name__ == "__main__":
    main()
