"""Checks of the benchmark on the host (no card needed).

    python -m pytest -q -p no:cacheprovider bench/checks/cpu_checks.py \
        bench/checks/card_checks.py

The file names keep them out of the repository's own test collection
(``test_*.py``): they are run by naming them.  They cover the import rule,
the resolution of every name in ``BENCHMARK.json``, the generator, the
roofline's byte functions, the command's refusal without a card, and the
comparison: every fault a cell can have, planted under a small run of the
harness on the host, answers past the true nearest neighbours, and the TF32
control, come out not correct.
"""

from __future__ import annotations

import ast
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(BENCH), str(BENCH / "checks")]

import torch  # noqa: E402

import datagen  # noqa: E402
import harness  # noqa: E402
import roofline  # noqa: E402

torch.set_num_threads(2)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


# --- the import rule ---------------------------------------------------------

def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    bad = _top_level_imports(path) & set(harness.FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"repro_torch", *harness.FORBIDDEN}
    assert _top_level_imports(path) <= {"__future__", "contextlib", "numpy",
                                        "torch"}


def test_a_run_loads_no_jax():
    """A whole (small, host) run leaves no JAX module in sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "cell = harness.resolve(%r)\n"
        "cell.config['n'] = 1500; cell.traffic['call_queries'] = 16\n"
        "harness.run_cell(cell, 7, 0.0, False, device='cpu', log=lambda s: 0)\n"
        "print(harness.forbidden_modules())\n" % (str(ROOT / "src"), str(BENCH),
                                                   CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- names resolve -------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c.chips in (1, 4)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    datagen.Traffic(**c.traffic)
    datagen.DataSpec(**c.config["data_spec"])
    harness.reference(c.config["reference"])
    cfg = harness.serve_config(c.config)
    assert cfg.index.p == c.config["p"] and cfg.data.n == c.config["n"]


def test_every_name_is_used():
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


# --- the generator -------------------------------------------------------------

SMALL = datagen.DataSpec(name="deep", dim=96)


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_generator_is_deterministic(seed):
    a = datagen.make_vectors(SMALL, 3000, seed)
    b = datagen.make_vectors(SMALL, 3000, seed)
    assert np.array_equal(a.vectors, b.vectors)
    assert np.array_equal(a.assign, b.assign)
    for base in ("uniform", "zipf"):
        t = datagen.Traffic(name="t", call_queries=64, base=base,
                            zipf_exponent=0.99 if base == "zipf" else 0.0)
        s1, s2 = datagen.QueryStream(a, t, seed), datagen.QueryStream(b, t, seed)
        assert np.array_equal(s1.call(3), s2.call(3))
        assert not np.array_equal(s1.call(3), s1.call(4))
        s3 = datagen.QueryStream(a, t, seed + 1)
        assert not np.array_equal(s1.call(3), s3.call(3))
    c = datagen.make_vectors(SMALL, 3000, seed + 1)
    assert not np.array_equal(a.vectors, c.vectors)


def test_generator_is_the_ports():
    from repro_torch.data import synth

    ds = synth.make_dataset("deep", n=2000, seed=5, compute_gt_k=0,
                            device="cpu")
    assert np.array_equal(datagen.make_vectors(SMALL, 2000, 5).vectors,
                          ds.vectors)


def test_zipf_cluster_shares():
    data = datagen.make_vectors(SMALL, 20000, 9)
    t = datagen.Traffic(name="z", call_queries=8192, base="zipf",
                        zipf_exponent=0.99)
    stream = datagen.QueryStream(data, t, 9)
    rng = np.random.default_rng(1)
    ids = np.concatenate([stream.base_ids(rng) for _ in range(8)])
    got = np.bincount(data.assign[ids], minlength=64) / len(ids)
    want = stream.cluster_p
    assert np.allclose(np.sort(want)[::-1], datagen.zipf_shares(64, 0.99))
    # binomial sd of a share over 65,536 draws is at most 0.002
    assert np.abs(got - want).max() < 0.01
    assert got.argmax() == want.argmax()


def test_zipf_shares_by_hand():
    s = datagen.zipf_shares(3, 1.0)
    assert np.allclose(s, np.array([1, 1 / 2, 1 / 3]) / (11 / 6))


# --- the roofline's byte functions ---------------------------------------------

def test_adc_slots_bytes_by_hand():
    # two queries: 3 hops, 20 reads, 120 dist comps; 1 hop, 8 reads, 58
    stats = {"hops": np.array([3, 1]), "reads": np.array([20, 8]),
             "dist_comps": np.array([120, 58])}
    # scored 100 + 50 = 150, each 24 code bytes + 4 out; 4 hops x 24 x 4
    assert roofline.adc_slots_bytes(stats, 24) == 150 * 28 + 4 * 96


def test_topk_bytes_by_hand():
    stats = {"branch_hops": np.array([[3, 0], [1, 2]]),
             "reads": np.array([20, 8]), "dist_comps": np.array([120, 58])}
    # later hops (3-1) + 0 + (1-1) + (2-1) = 3: beam 64 in and out a hop;
    # scored 150 in; reads 28 in and out; 8 bytes a pair
    assert roofline.topk_bytes(stats, 64) == 8 * (2 * 64 * 3 + 150 + 2 * 28)


def test_kernel_seconds_by_name():
    ks = {"(anonymous namespace)::adc_slots_direct(float const*, unsigned "
          "char const*, float*, int, int, int)": 1.5,
          "adc_slots_staged(float const*)": 0.5,
          "void (anonymous namespace)::topk_kernel<2>(float const*, int "
          "const*, int)": 2.0,
          "void at::native::elementwise_kernel<128, 4>(int)": 9.0}
    assert roofline.kernel_seconds(ks, ("adc_slots_direct",
                                        "adc_slots_staged")) == 2.0
    assert roofline.kernel_seconds(ks, ("topk_kernel",)) == 2.0
    assert roofline.share(3.35e12, 2.0, "NVIDIA H100 80GB HBM3") == 50.0
    assert roofline.share(1.0, 0.0, "NVIDIA H100 80GB HBM3") is None


def test_trace_summary_by_hand():
    import tracing

    ev = [("k1", True, 10, 20, 0), ("k2", True, 15, 30, 0),
          ("k1", True, 50, 60, 0), ("aten::item", False, 30, 50, 1),
          ("aten::add", False, 0, 8, 1), ("cudaLaunchKernel", False, 9, 10, 1)]
    s = tracing.summarize(ev, 100e-9)
    assert s.kernel_s == {"k1": 20e-9, "k2": 15e-9}
    assert s.busy_s == pytest.approx(30e-9) and s.window_s == 100e-9
    gaps = dict(tracing.idle_gaps(ev, (0, 100)))
    # gaps: 0-10 (aten::add from 0 to 8 covers 0), 30-50 (aten::item),
    # 60-100 (none running)
    assert gaps["aten::add"] == pytest.approx(10e-9)
    assert gaps["aten::item"] == pytest.approx(20e-9)
    assert gaps["python"] == pytest.approx(40e-9)
    # a span that cuts a device interval counts only its part inside
    assert dict(tracing.idle_gaps(ev, (25, 55))) == {
        "aten::item": pytest.approx(20e-9)}
    with pytest.raises(RuntimeError, match="no device event"):
        tracing.summarize([e for e in ev if not e[1]], 100e-9)
    with pytest.raises(RuntimeError, match="no device event"):
        tracing.idle_gaps(ev, (70, 100))


# --- the command ---------------------------------------------------------------

def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is the host's")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


# --- the comparison: small runs of the harness on the host ---------------------

def small_cell(name: str):
    cell = harness.resolve(name)
    cell.config["n"] = 1500
    cell.traffic["call_queries"] = 32
    s = cell.config["serve"]["search"]
    if "slots" in s:
        s.update(slots=8, pair_cap=4, result_cap=8)
    return cell


def run_small(name: str, seed: int = 5):
    return harness.run_cell(small_cell(name), seed, 0.0, False, device="cpu",
                            log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_small_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 32
    assert list(out)[-1] == "_verdict_lines" and list(out)[-2] == "checks"
    assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    json.loads(json.dumps({k: v for k, v in out.items()
                           if k != "_verdict_lines"}))


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged_step(states, *args, **kwargs):
    """The search step's state comes back unchanged; only its hop count
    moves."""
    c = states.counters
    return states._replace(counters=c._replace(hops=c.hops + 1))


def _fault_unchanged_step():
    import dataclasses

    from repro_torch.core import baton

    stack = contextlib.ExitStack()
    stack.enter_context(patched(baton, "step_disk_batched", _unchanged_step))
    # a stuck state holds its slot until the engine's caps: lower them so
    # that the host gets there in seconds (the answers stay undelivered)
    real = baton.run_simulated

    def capped(index, queries, cfg, *a, **kw):
        return real(index, queries, dataclasses.replace(
            cfg, max_supersteps=4, max_local_steps=4), *a, **kw)
    stack.enter_context(patched(baton, "run_simulated", capped))
    return stack


def _fault_half_batch():
    from repro_torch.core import baton

    real = baton.run_simulated

    def half(index, queries, *a, **kw):
        return real(index, queries[:len(queries) // 2], *a, **kw)
    return patched(baton, "run_simulated", half)


def _fault_no_exchange():
    from repro_torch.core import baton

    return patched(baton, "merge_recv",
                   lambda dev, incoming, cfg, codebook, meter: dev)


def _fault_altered_answer():
    from repro_torch.core import baton

    real = baton._collect

    def collect(*a, **kw):
        ids, dists, out = real(*a, **kw)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % 1500
        return ids, dists, out
    return patched(baton, "_collect", collect)


# the faults a cell of the baton engine can have, planted where the engine
# makes what they break
FAULTS = {
    "unchanged_step": _fault_unchanged_step,
    "half_batch": _fault_half_batch,
    "no_exchange": _fault_no_exchange,
    "altered_answer": _fault_altered_answer,
}


@pytest.mark.parametrize("cell,fault", [(c, f) for f in FAULTS for c in CELLS])
def test_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
        out = run_small(cell)
    assert not out["correct"], (fault, out["checks"])


def test_recall_floor_sees_lost_neighbours():
    """Answers of real ids at their exact distances, in order, but past the
    true top-k: only ``recall_miss`` fails them."""
    import judge

    ref = harness.reference("exact_l2")
    g = torch.Generator().manual_seed(3)
    base = torch.randn(400, 8, generator=g)
    queries = torch.randn(24, 8, generator=g)
    exact = ref.search(base, queries, 30)
    for first, correct in ((0, True), (20, False)):
        ids = exact[:, first:first + 10]
        dists = ref.distances(base, queries, ids)
        v = judge.judge(ref, base, queries, ids.numpy(), dists.numpy(), 10,
                        0.6)
        assert v.correct is correct, v.checks
        assert v.checks["recall_miss"]["value"] == (0.0 if correct else 1.0)
        for name in ("undelivered", "bad_rows", "dist_rel_err"):
            assert v.checks[name]["value"] <= v.checks[name]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in TF32 (emulated on the host) in the program's place."""
    import control

    v = control.control_verdict(small_cell(cell), 5, 2, "cpu")
    assert not v.correct
    assert v.checks["dist_rel_err"]["value"] > 10 * v.checks[
        "dist_rel_err"]["limit"]
