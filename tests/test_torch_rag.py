"""The port's RAG pipeline against the reference's: the reference's
``build_demo`` system (its index carried across with ``index_state`` /
``load_index``, its LM with ``params_from_tree``) answers the same requests
in both packages — ids and the five counters equal, dists within rtol 1e-5
(the order of the exact L2 sum), generated tokens equal.  The port's own
``build_demo`` draws the reference's doc tokens and finds perturbed docs
at rank 1; ``serve_retrieval`` on the thread tier answers as ``retrieve``."""

import jax
import numpy as np
import pytest

from repro.serving import rag as rrag
from repro_torch.api import Deployment, STAT_KEYS, get_engine
from repro_torch.configs.batann_serve import ServeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.serving import rag as trag

N_DOCS, D = 400, 32


@pytest.fixture(scope="module")
def ref_sys():
    return rrag.build_demo(n_docs=N_DOCS, d=D, p=4, seed=0)


@pytest.fixture(scope="module")
def port_sys(ref_sys):
    """The reference's system, carried across to the port on the CPU."""
    eng = get_engine("baton", device="cpu")
    eng.load_index(*ref_sys.deployment.engine.index_state())
    cfg = ServeConfig.from_dict(ref_sys.deployment.config.to_dict())
    lm_cfg = get_smoke_config("qwen2-0.5b")
    return trag.RAGSystem(
        deployment=Deployment.from_parts(cfg, eng),
        doc_tokens=ref_sys.doc_tokens, lm_cfg=lm_cfg,
        lm_params=TT.params_from_tree(
            lm_cfg, jax.tree.map(np.asarray, ref_sys.lm_params),
            device="cpu"))


def _requests(sys, n, seed=0):
    """Queries near known docs (each doc vector plus 0.01 noise, as the
    reference's RAG test makes them) and random prompts."""
    rng = np.random.default_rng(seed)
    idx = sys.index
    n2p, n2l = np.asarray(idx.node2part), np.asarray(idx.node2local)
    vecs = np.asarray(idx.part_vectors)[n2p, n2l]
    target = rng.integers(0, len(n2p), size=n)
    queries = vecs[target] + 0.01 * rng.normal(size=(n, vecs.shape[1])
                                               ).astype(np.float32)
    prompt = rng.integers(0, sys.lm_cfg.vocab_size, size=(n, 4)).astype(
        np.int32)
    return target, queries.astype(np.float32), prompt


def test_answer_equals_reference(ref_sys, port_sys, monkeypatch):
    _, queries, prompt = _requests(ref_sys, 6)
    seen = []
    retrieve = ref_sys.retrieve
    # keep the dists of the reference's own retrieval (it re-jits per call)
    monkeypatch.setattr(ref_sys, "retrieve",
                        lambda q: seen.append(retrieve(q)) or seen[-1])
    want_out, want_ids, want_stats = ref_sys.answer(queries, prompt,
                                                    max_new=4)
    timings = {}
    got_out, got_ids, got_stats = port_sys.answer(queries, prompt,
                                                  max_new=4, timings=timings)
    assert got_out.shape == (6, 4) and got_out.dtype == np.int32
    np.testing.assert_array_equal(got_ids, want_ids)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got_stats[k], want_stats[k], err_msg=k)
    assert got_stats["delivered"] == want_stats["delivered"] == 1.0
    np.testing.assert_array_equal(got_out, want_out)
    assert sorted(timings) == ["decode", "prefill", "retrieve"]
    np.testing.assert_allclose(port_sys.retrieve(queries)[1], seen[0][1],
                               rtol=1e-5)


def test_serve_retrieval_thread_tier(port_sys):
    _, queries, _ = _requests(port_sys, 8, seed=1)
    ids, dists, _ = port_sys.retrieve(queries)
    res = port_sys.serve_retrieval(queries, workers=2)
    assert res.completed == 8
    np.testing.assert_array_equal(res.ids, ids)
    np.testing.assert_array_equal(res.dists, dists)


def test_port_build_demo(ref_sys):
    """The port's own build: the reference's doc tokens for the seed, and
    perturbed docs retrieved at rank 1 (the reference's bar, 0.75)."""
    sys = trag.build_demo(n_docs=N_DOCS, d=D, p=4, seed=0, device="cpu")
    np.testing.assert_array_equal(sys.doc_tokens, ref_sys.doc_tokens)
    assert sys.search_cfg.adc_impl == "gather"
    assert sys.search_cfg.merge_impl == "lexsort"
    target, queries, prompt = _requests(sys, 8, seed=2)
    out, ids, stats = sys.answer(queries, prompt, max_new=4)
    assert out.shape == (8, 4)
    assert (ids[:, 0] == target).mean() >= 0.75
    assert stats["delivered"] == 1.0
