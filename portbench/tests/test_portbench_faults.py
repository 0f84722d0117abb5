"""A run with the timed path broken underneath must come out not
correct: the harness is driven on the CPU (past its look for a card) at
a small size, with the fused clause kernel's entry point replaced by one
that alters an answer where it is produced, or that leaves half of the
batch out.  The unbroken run comes out correct.  Besides the benchmark's
cell, a checkout with a service cell added (convcotm-mnist under the
`single-poisson-overload` mix) drives the service's generator too."""

import json
import shutil
import time

import pytest
import torch

from harness.cell import ROOT, load_benchmark, run_cell

CELLS = {
    "mnist-service": {"cfg": {"pool_images": 48},
                      "traffic": {"rate_per_s": 60, "warm_requests": 4}},
    "fmnist-bulk": {"cfg": {"pool_images": 48}, "traffic": {"batch": 16, "warm_calls": 1}},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the service cell."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "portbench", r / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load_benchmark(ROOT)
    if "convcotm-mnist" not in {c["name"] for c in b["configs"]}:
        b["configs"].append({"name": "convcotm-mnist", "source": "test", "reduced": [],
                             "why": "test", "file": "portbench/configs/convcotm-mnist.json"})
    b["workloads"].append({"name": "mnist-service", "config": "convcotm-mnist",
                           "traffic": "single-poisson-overload", "chips": 1, "why": "test"})
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    return r


def _altered(fn):
    def broken(lit, *a, **kw):
        out = fn(lit, *a, **kw).clone()
        out[0, 0] += 1
        return out
    return broken


def _half_left_out(fn):
    def broken(lit, *a, **kw):
        out = fn(lit, *a, **kw).clone()
        out[lit.shape[0] // 2 :] = 0
        return out
    return broken


def _run(cell, root):
    return run_cell(cell, 11, 0.6, False, proc_start=time.perf_counter(), device="cpu",
                    root=root, overrides=CELLS[cell], log=lambda s: None)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_unbroken_run_is_correct(cell, root):
    out = _run(cell, root)
    assert out["correct"] and out["checks"]["bad_answers"]["value"] == 0


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["altered", "half_left_out"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_timed_path_is_not_correct(cell, fault, root, monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "fused_infer", fault(ops.fused_infer))
    out = _run(cell, root)
    assert not out["correct"] and out["checks"]["bad_answers"]["value"] > 0
