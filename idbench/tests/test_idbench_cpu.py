"""Self-tests of the benchmark on the CPU, at a tiny size.

    python -m pytest idbench/tests -q

The harness's look for a card is skipped (``harness.run`` is called with
the CPU); everything else of a run is driven: inputs, the port's index,
the window, the reference's judgement, the result object.
"""

from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from idbench import control, data, harness
from idbench.kinds import SetupError
from idbench.reference.ivf import MISSING, ReferenceIVF, round_tf32

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2 ** 33 + 12345  # larger than 32 signed bits hold
TINY = dict(n=20000, d=32, nlist=64, nprobe=4, center_std=0.5,
            limits={"dist_err": 1e-5, "rank_gap": 1e-5})
TINY_TRAFFIC = dict(pool=2000, queries_per_call=200, warmup_calls=2, check_calls=6,
                    trace_warmup_calls=1, trace_calls=2)


def _add(root: Path, name: str, payload: str, scan_path: str, pq_m: int = 0,
         mixes=("tiny-batch",)) -> None:
    """A configuration and its cells, added as a new file and new entries."""
    cfg = json.loads((root / "idbench/configs/sift1m-ivf1024-flat-roc.json").read_text())
    cfg.update(TINY, name=name, payload=payload, pq_m=pq_m, scan_path=scan_path)
    (root / f"idbench/configs/{name}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "file": f"idbench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    for mix in mixes:
        bench["workloads"].append({"name": f"{name}.{mix}", "config": name, "traffic": mix,
                                   "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def root(tmp_path):
    """A copy of the benchmark with a tiny traffic mix, a tiny flat and a
    tiny PQ configuration, and a per-layer metric for them, each added as
    new files and entries (no file that was there is edited)."""
    shutil.copytree(REPO / "idbench", tmp_path / "idbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    batch = json.loads((tmp_path / "idbench/traffic/batch1000.json").read_text())
    batch.update(TINY_TRAFFIC, name="tiny-batch")
    (tmp_path / "idbench/traffic/tiny-batch.json").write_text(json.dumps(batch))
    single = json.loads((tmp_path / "idbench/traffic/single.json").read_text())
    single.update(TINY_TRAFFIC, name="tiny-single", queries_per_call=1, check_calls=4)
    (tmp_path / "idbench/traffic/tiny-single.json").write_text(json.dumps(single))
    _add(tmp_path, "tiny-flat", "flat", "float", mixes=("tiny-batch", "tiny-single"))
    _add(tmp_path, "tiny-pq", "pq", "float", pq_m=4)
    (tmp_path / "idbench/metrics/calls_traced.tiny.py").write_text(
        "def read(ctx):\n    return float(len(ctx.spans['positional']))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_traced.tiny", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "test", "moves": "qps",
                               "workloads": ["tiny-flat.tiny-batch", "tiny-pq.tiny-batch"]})
    bench["end_to_end"][0]["workloads"] += ["tiny-flat.tiny-batch", "tiny-pq.tiny-batch"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    changed = [p for p, b in before.items() if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []
    return tmp_path


def _run(root, cell, trace=False, fault=None, seconds=0.5):
    return harness.run(harness.load_cell(cell, root), SEED, seconds, trace, torch.device("cpu"),
                       fault=fault)


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.config["kind"] == "ivf" and cell.kind.__file__.endswith("kinds/ivf.py")
        assert set(cell.config["limits"]) == {"dist_err", "rank_gap"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end:
            assert (REPO / "idbench/end_to_end" / f"{m['name']}.py").exists()
        for m in cell.per_layer:
            assert harness.reader_path(REPO, "metrics", m["name"]).exists()
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", ["tiny-flat.tiny-batch", "tiny-pq.tiny-batch",
                                  "tiny-flat.tiny-single"])
def test_port_agrees_with_reference(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["check"]
    assert out["check"]["dist_err"]["value"] < 1e-6


def test_lut_scan_agrees_with_reference(root, monkeypatch):
    """The PQ LUT scan, reached at this size only by lowering the port's
    budget (a test may; a run never sets a constant of the port)."""
    from vector_db_id_compression_tpu_torch.search import ivf

    _add(root, "tiny-lut", "pq", "lut", pq_m=4)
    monkeypatch.setattr(ivf, "PQ_DECODE_BUDGET", 0)
    assert _run(root, "tiny-lut.tiny-batch")["correct"]


def test_scan_path_is_checked(root):
    _add(root, "tiny-wrong", "pq", "lut", pq_m=4)
    with pytest.raises(SetupError):
        _run(root, "tiny-wrong.tiny-batch")


def test_result_line_schema(root):
    out = _run(root, "tiny-flat.tiny-batch")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"qps", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))
    traced = _run(root, "tiny-flat.tiny-batch", trace=True, seconds=3.0)
    assert set(traced["metrics"]) == {"calls_traced.tiny"}
    assert traced["metrics"]["calls_traced.tiny"]["value"] == traced["attempted"] / 200


TOY_KIND = '''"""A toy kind: brute-force flat search, the whole corpus in one product."""

from types import SimpleNamespace

import torch

from idbench import check as verdicts
from idbench.reference.toyflat import exact_topk


def make_inputs(cfg, seed, pool, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    xb = torch.randn((cfg["n"], cfg["d"]), generator=g, device=device)
    src = torch.randint(0, cfg["n"], (pool,), generator=g, device=device)
    queries = xb[src] + 0.1 * torch.randn((pool, cfg["d"]), generator=g, device=device)
    return SimpleNamespace(xb=xb, queries=queries)


def build(cfg, inputs, device):
    return SimpleNamespace(xb=inputs.xb, norms=(inputs.xb ** 2).sum(1))


def call(index, cfg, traffic, xq):
    d = index.norms[None] - 2 * xq @ index.xb.T + (xq ** 2).sum(1, keepdim=True)
    return tuple(torch.topk(d, traffic["k"], dim=1, largest=False))


class Spans:
    def __init__(self, index, device):
        self.index, self.recording = index, False

    def context(self):
        return {"toy_rows": self.index.xb.shape[0]}


class Reference:
    def __init__(self, cfg, seed, pool, device):
        self.cfg, self.inputs = cfg, make_inputs(cfg, seed, pool, device)
        self.seconds = {"reference": 0.0}

    def judge(self, traffic, sample):
        D = torch.cat([out[0] for _, out in sample])
        I = torch.cat([out[1] for _, out in sample])
        return self._verdict(traffic, self._queries(traffic, sample), D, I)

    def control(self, traffic, sample):
        xq = self._queries(traffic, sample)
        return self._verdict(traffic, xq, *exact_topk(self.inputs.xb, xq, traffic["k"],
                                                      torch.bfloat16))

    def _queries(self, traffic, sample):
        nq = traffic["queries_per_call"]
        return torch.cat([self.inputs.queries[s:s + nq] for s, _ in sample])

    def _verdict(self, traffic, xq, D, I):
        xb = self.inputs.xb
        ref_d, _ = exact_topk(xb, xq, traffic["k"], torch.float64)
        scale = 2 * (xq.double() ** 2).sum(1, keepdim=True)
        own = ((xq.double()[:, None] - xb.double()[I]) ** 2).sum(-1)
        per = {"dist_err": ((D.double() - own).abs() / scale).amax(1),
               "rank_gap": ((own.sort(1).values - ref_d) / scale).amax(1)}
        return verdicts.judge({n: per[n] for n in READ}, self.cfg["limits"])


# the numbers that this kind reads (a test narrows it)
READ = ("dist_err", "rank_gap")
'''

TOY_REFERENCE = '''"""The toy kind's plain reference: exact top-k by squared L2."""

import torch


def exact_topk(xb, xq, k, dtype):
    d = torch.cdist(xq.to(dtype).double(), xb.to(dtype).double()) ** 2
    return tuple(torch.topk(d, k, dim=1, largest=False))
'''


@pytest.fixture
def toy(root, monkeypatch):
    """The root's copy with a new kind added as files alone: a kind file, its
    reference under ``idbench/reference/``, a configuration, a reader of the
    kind's own context and the cell's entries; ``harness.py`` untouched."""
    import idbench.reference

    harness_before = (root / "idbench/harness.py").read_bytes()
    (root / "idbench/kinds/toyflat.py").write_text(TOY_KIND)
    (root / "idbench/reference/toyflat.py").write_text(TOY_REFERENCE)
    (root / "idbench/metrics/toy_rows.py").write_text("def read(ctx):\n    return ctx.toy_rows\n")
    # the copy's idbench/reference/ is where ``idbench.reference.toyflat`` resolves
    monkeypatch.setattr(idbench.reference, "__path__",
                        [str(root / "idbench/reference"), *idbench.reference.__path__])
    monkeypatch.delitem(sys.modules, "idbench.reference.toyflat", raising=False)
    cfg = {"name": "toy", "kind": "toyflat", "n": 3000, "d": 16,
           "limits": {"dist_err": 1e-5, "rank_gap": 1e-5}}
    (root / "idbench/configs/toy.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test", "file": "idbench/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy.tiny-batch", "config": "toy",
                               "traffic": "tiny-batch", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("toy.tiny-batch")
    bench["per_layer"].append({"name": "toy_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "qps",
                               "workloads": ["toy.tiny-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    yield root
    assert (root / "idbench/harness.py").read_bytes() == harness_before


def test_a_new_kind_comes_as_files_alone(toy):
    """A kind added as one file (with its reference, configuration, reader
    and entries) runs through ``harness.run``: untraced and traced, its
    check passes the program and fails an altered answer and its control."""
    out = _run(toy, "toy.tiny-batch")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"qps", "setup_s"} and set(out["check"]) == {"dist_err",
                                                                                "rank_gap"}
    traced = _run(toy, "toy.tiny-batch", trace=True, seconds=1.0)
    assert traced["correct"] and traced["metrics"]["toy_rows"]["value"] == 3000

    def altered(index):
        index.xb = index.xb.clone()
        index.xb[0] += 1.0
    assert not _run(toy, "toy.tiny-batch", fault=altered)["correct"]
    cells = [harness.load_cell("toy.tiny-batch", toy)]
    (row,) = control.readings(cells[0].config, cells, SEED, 0.5, True, torch.device("cpu"))
    assert not row["control_correct"] and row["program"]["dist_err"] < 1e-6


def test_a_kind_that_leaves_a_limit_unread_gives_no_result(toy):
    """A kind whose check reads fewer numbers than the configuration has
    limits stops the run, naming them, rather than passing unchecked."""
    cell = harness.load_cell("toy.tiny-batch", toy)
    cell.kind.READ = ("dist_err",)
    with pytest.raises(ValueError, match="rank_gap"):
        harness.run(cell, SEED, 0.5, False, torch.device("cpu"))


@pytest.mark.parametrize("kind,says", [(None, "no key 'kind'"),
                                       ("graph-to-come", "'graph-to-come'")])
def test_configuration_without_a_kind_file_fails_in_load_cell(root, kind, says):
    cfg = json.loads((root / "idbench/configs/tiny-flat.json").read_text())
    cfg.pop("kind")
    if kind is not None:
        cfg["kind"] = kind
    (root / "idbench/configs/tiny-flat.json").write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match=says):
        harness.load_cell("tiny-flat.tiny-batch", root)


def test_list_sizes_are_the_profiles_for_every_seed():
    """Fixed quantiles of the profile: the sizes sum to n, rise with the
    quantiles, and each seed only deals them out to other centres."""
    cfg = json.loads((REPO / "idbench/configs/sift1m-ivf1024-flat-roc.json").read_text())
    sizes = data.list_sizes(cfg["n"], cfg["nlist"], cfg["list_size_quantiles"])
    assert int(sizes.sum()) == cfg["n"] and bool((sizes[1:] >= sizes[:-1]).all())
    assert int(sizes[-1]) > 1.9 * cfg["n"] / cfg["nlist"] > 3.8 * int(sizes[0])
    tiny = dict(cfg, **TINY)
    tiny["center_std"] = 3.0  # far apart: every row nearest its own centre
    owners = []
    for seed in (SEED, 7):
        x = data.make_inputs(tiny, seed, 10, torch.device("cpu"))
        d = torch.cdist(x.xb, x.centroids).argmin(1)
        owners.append(torch.bincount(d, minlength=TINY["nlist"]).sort().values)
    want = data.list_sizes(TINY["n"], TINY["nlist"], cfg["list_size_quantiles"])
    for counts in owners:
        assert torch.equal(counts, want)


def test_banned_module_loaded_after_the_window_gives_no_result(root, monkeypatch, capsys):
    """A per-layer reader, which runs after the window, loads a module named
    like a banned one: the run prints no result and exits nonzero."""
    stub = root / "stub"
    stub.mkdir()
    (stub / "flax.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    (root / "idbench/metrics/loads_flax.tiny.py").write_text(
        "import flax  # noqa: F401\n\n\ndef read(ctx):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_flax.tiny", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "qps",
                               "workloads": ["tiny-flat.tiny-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert harness.banned_loaded() == []
    try:
        out = _run(root, "tiny-flat.tiny-batch", trace=True, seconds=1.0)
        assert "loads_flax.tiny" in out["metrics"]
        capsys.readouterr()
        assert harness.emit(out) != 0
        assert capsys.readouterr().out == ""
    finally:
        sys.modules.pop("flax", None)
    assert harness.emit(out) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def _half_batch(index):
    """Half of the batch left out: the second half answered with the first's."""
    search = index.search_defer_id_decoding

    def broken(xq, k, nprobe, **kw):
        h = xq.shape[0] // 2
        D, I = search(xq[:h], k, nprobe, **kw)
        return torch.cat([D, D[: xq.shape[0] - h]]), torch.cat([I, I[: xq.shape[0] - h]])
    index.search_defer_id_decoding = broken


def _altered_id(index):
    """An answer altered where it is produced: the translate's first id."""
    translate = index._translate

    def broken(labels, decode_1by1=False):
        ids = translate(labels, decode_1by1).clone()
        ids.view(-1)[0] = (ids.view(-1)[0] + 1) % index.ntotal
        return ids
    index._translate = broken


@pytest.mark.parametrize("fault,cell", [(_half_batch, "tiny-flat.tiny-batch"),
                                        (_altered_id, "tiny-flat.tiny-batch"),
                                        (_altered_id, "tiny-pq.tiny-batch"),
                                        (_altered_id, "tiny-flat.tiny-single")])
def test_faults_fail_the_check(root, fault, cell):
    out = _run(root, cell, fault=fault)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("config", ["tiny-flat", "tiny-pq"])
def test_control_fails_the_check(root, config):
    """The reference in TF32 in the program's place comes out not correct;
    the program's readings on the same seeds stay below the limits."""
    cells = [harness.load_cell(f"{config}.tiny-batch", root)]
    for seed in (SEED, 7):
        (row,) = control.readings(cells[0].config, cells, seed, 0.5, True, torch.device("cpu"))
        assert not row["control_correct"]
        assert row["control"]["dist_err"] > 10 * row["program"]["dist_err"]
        assert all(row["program"][n] <= TINY["limits"][n] for n in TINY["limits"])


def test_reference_reads_missing_and_repeated_ids():
    g = torch.Generator().manual_seed(3)
    cent = torch.randn(8, 16, generator=g)
    xb = cent[torch.randint(0, 8, (2000,), generator=g)] + torch.randn(2000, 16, generator=g)
    ref = ReferenceIVF(cent, xb)
    xq = xb[:4] + 0.01
    D, I = ReferenceIVF(cent, xb, precision="float64").search(xq, 5, 3)
    dist_err, rank_gap = ref.judge(xq, D, I, 3)
    assert float(dist_err.max()) < 1e-6 and float(rank_gap.max()) <= 0
    I2 = I.clone()
    I2[0, 1] = I2[0, 0]
    I2[1, 2] = -1
    _, rank_gap = ref.judge(xq, D, I2, 3)
    assert rank_gap[0] == MISSING and rank_gap[1] == MISSING and rank_gap[2] <= 0


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000001])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


BANNED = {"jax", "jaxlib", "flax", "vector_db_id_compression_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    files = list((REPO / "idbench").rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in BANNED, (f, name)


def test_reference_imports_nothing_of_the_port():
    for f in (REPO / "idbench/reference").rglob("*.py"):
        for name in _imports(f):
            assert not name.split(".")[0].startswith("vector_db_id_compression_tpu"), (f, name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tiny_cell_on_the_card(root, card):
    out = harness.run(harness.load_cell("tiny-flat.tiny-batch", root), SEED, 0.5, True, card)
    assert out["correct"] and out["device"]["platform"] == "gpu"
