"""PyTorch port, `ledger`: `mxnet_tpu_torch.ledger` against the JAX
package's `mxnet_tpu.ledger` on the same seeded records (flatten_metrics,
series, detect, verdict, gate, the tier-1 record), both packages'
torn-line-tolerant readers on one file with torn and garbage lines, a
ledger the port wrote read and gated unchanged by
`tools/ledger_report.py`, the port's provenance (`platform` "gpu" once
CUDA is initialised, from torch), its PERF_KNOBS, and the off fast path.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu import ledger as ledger_j

from mxnet_tpu_torch import config
from mxnet_tpu_torch import ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(ROOT, "tools", "ledger_report.py")


@pytest.fixture(autouse=True)
def _clean():
    yield
    ledger.reset()
    config.reset()


def _prov(mod, platform="gpu", devices=1, smoke=False, cfg="cafef00d"):
    return mod.build_provenance(platform=platform, devices=devices,
                                smoke_mode=smoke, rev="testrev",
                                fingerprint=cfg, knobs={})


def _records(mod, seed, n=9, **prov):
    """Seeded run records of three metrics (a throughput, a latency and a
    multi-row bench), the last few drifting, on `mod`'s builders."""
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        drift = 0.7 if i >= n - 2 and seed % 2 else 1.0
        rows = [{"metric": "fleet", "fleet_tokens_per_sec":
                 float(200 * drift + rng.randn()),
                 "ttft_p99_ms": float(900 / drift + 10 * rng.randn()),
                 "failover_dropped_requests": 0},
                {"phase": "solo", "single_tokens_per_sec":
                 float(110 + rng.randn()), "note": "text",
                 "ok": True}]
        recs.append(mod.build_run_record(
            "chip_smoke", rows, provenance=_prov(mod, **prov),
            ts=1000.0 + i, label=f"run{i}", digest={}))
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_records_series_and_gate_equal_jax(seed):
    port, jax = _records(ledger, seed), _records(ledger_j, seed)
    for a, b in zip(port, jax):
        assert {k: v for k, v in a.items() if k != "iso"} == \
            {k: v for k, v in b.items() if k != "iso"}
    s_port, s_jax = ledger.series(port), ledger_j.series(jax)
    assert s_port == s_jax and len(s_port) == 5
    for (key, metric), pts in s_port.items():
        hb = ledger.higher_is_better(metric)
        assert hb == ledger_j.higher_is_better(metric)
        values = [p["value"] for p in pts]
        assert ledger.detect(values, hb) == ledger_j.detect(values, hb)
        for kw in ({}, {"window": 4, "min_samples": 2},
                   {"z_thresh": 2.0, "rel_thresh": 0.05}):
            assert ledger.verdict(pts, hb, **dict(kw)) == \
                ledger_j.verdict(pts, hb, **dict(kw))
    assert ledger.gate(port) == ledger_j.gate(jax)
    assert ledger.gate(port)[0] == (1 if seed % 2 else 0)


@pytest.mark.parametrize("rows", [
    [{"metric": "tps", "value": 5.0, "note": "x"}],
    [{"metric": "kernel_a", "speedup": 2.0, "pallas_ms": 1.0},
     {"path": "on_device", "tokens_per_sec": 10.0}],
    [{"fleet_tokens_per_sec": 1.5, "failover_dropped_requests": 0,
      "ok": True, "platform": "gpu"}],
    [{"kernel": "paged_attention", "ms": 0.01, "bound_ms": 0.003},
     {"config": "float32", "ms": 0.02, "passed": 3}, "not a row"],
])
def test_flatten_metrics_equal_jax(rows):
    assert ledger.flatten_metrics(rows) == ledger_j.flatten_metrics(rows)
    for name in ledger.flatten_metrics(rows):
        assert ledger.higher_is_better(name) == \
            ledger_j.higher_is_better(name)


def test_torn_and_garbage_lines_read_alike(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    recs = _records(ledger, 5, n=4)
    ledger.append_record(path, recs[0])
    with open(path, "a") as f:
        f.write("not json at all\n[1, 2, 3]\n\n")
    ledger.append_record(path, recs[1])
    with open(path, "a") as f:                # a crashed writer's tail
        f.write('{"kind": "run", "bench": "chip_smoke", "metr')
    ledger.append_record(path, recs[2])       # heals onto a fresh line
    ledger_j.append_record(path, recs[3])     # the JAX writer, same file
    got, ref = ledger.read_records(path), ledger_j.read_records(path)
    assert got == ref
    assert [r["kind"] for r in got] == ["meta", "run", "run", "run", "run"]
    assert [r["label"] for r in got[1:]] == ["run0", "run1", "run2", "run3"]
    assert ledger.read_records(str(tmp_path)) == got
    assert ledger.series(got) == ledger_j.series(ref)


def test_tier1_record_equal_jax():
    kw = dict(skipped=3, slowest=[("t%d" % i, 20.0 - i) for i in range(12)],
              ts=1234.0)
    a = ledger.build_tier1_record(500.0, 880, 2, provenance=_prov(ledger),
                                  **kw)
    b = ledger_j.build_tier1_record(500.0, 880, 2,
                                    provenance=_prov(ledger_j), **kw)
    assert a == b and len(a["slowest"]) == 10


def test_record_on_the_card_keys_gpu_one_device(tmp_path, monkeypatch):
    """A process that has initialised CUDA records platform "gpu" and one
    device, so its numbers never share a series with a CPU run's."""
    import torch
    assert ledger.torch_provenance() == (None, None, None)
    config.set("ledger_dir", str(tmp_path))
    ledger.enable()
    cpu = ledger.record_run("chip_smoke", [{"metric": "m", "value": 1.0,
                                            "platform": "cpu",
                                            "devices": 1,
                                            "smoke_mode": True}])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert ledger.torch_provenance() == ("gpu", 1, False)
    card = ledger.record_run("chip_smoke", [{"metric": "m", "value": 2.0}])
    prov = card["provenance"]
    assert (prov["platform"], prov["devices"], prov["smoke_mode"]) == \
        ("gpu", 1, False)
    assert prov["fingerprint"] and set(prov["knobs"]) == \
        set(ledger.PERF_KNOBS)
    keys = {k for k, _ in ledger.series(ledger.read_records(str(tmp_path)))}
    assert len(keys) == 2
    assert any("|platform=gpu|devices=1|smoke=False|" in k for k in keys)
    assert ledger.provenance_key(cpu) != ledger.provenance_key(card)
    assert ledger.gate(ledger.read_records(str(tmp_path))) == (2, [])


def test_perf_knobs_are_the_ports_and_split_the_series():
    declared = config.describe()
    assert ledger.PERF_KNOBS and all(k in declared
                                     for k in ledger.PERF_KNOBS)
    assert set(ledger.PERF_KNOBS) < set(ledger_j.PERF_KNOBS)
    fp1, knobs = ledger.config_fingerprint()
    assert knobs["serve_slots"] == config.get("serve_slots")
    config.set("serve_slots", config.get("serve_slots") + 1)
    assert ledger.config_fingerprint()[0] != fp1


def test_off_is_a_zero_hook_fast_path(monkeypatch, tmp_path):
    assert not ledger.enabled()

    def boom(*a, **k):
        raise AssertionError("hook ran with the ledger off")

    monkeypatch.setattr(ledger, "build_run_record", boom)
    monkeypatch.setattr(ledger, "append_record", boom)
    assert ledger.record_run("chip_smoke", [{"metric": "m",
                                             "value": 1.0}]) is None
    assert ledger.record_tier1(10.0, 5, 0) is None
    with pytest.raises(ValueError):
        ledger.enable()
    assert list(tmp_path.iterdir()) == []


def _report(*args, gate=None):
    env = dict(os.environ)
    env.pop("MXNET_TPU_LEDGER_GATE", None)
    if gate is not None:
        env["MXNET_TPU_LEDGER_GATE"] = gate
    return subprocess.run([sys.executable, REPORT, *args],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_ledger_report_reads_and_gates_the_ports_ledger(tmp_path):
    """tools/ledger_report.py (which loads the JAX package's ledger.py by
    path) renders and gates a ledger the port wrote, unchanged: a
    confirmed regression of a card series fails the gate, naming the
    metric and the first bad run; ledger_gate=warn downgrades it."""
    config.set("ledger_dir", str(tmp_path))
    ledger.enable()
    for rec in _records(ledger, 1):            # drifting: confirmed
        ledger.append_record(ledger.ledger_path(), rec)
    ledger.record_tier1(400.0, 2599, 0)
    text = open(ledger.ledger_path()).read()
    rep = _report(str(tmp_path))
    assert rep.returncode == 0, rep.stderr
    assert "bench=chip_smoke|platform=gpu|devices=1|smoke=False" \
        in rep.stdout
    assert "first bad: run7" in rep.stdout
    r = _report(str(tmp_path), "--gate")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "CONFIRMED regression: fleet.fleet_tokens_per_sec" in r.stdout
    assert "first bad run: run7" in r.stdout
    r = _report(str(tmp_path), "--gate", gate="warn")
    assert r.returncode == 0 and "DOWNGRADED" in r.stdout
    assert open(ledger.ledger_path()).read() == text  # read, not rewritten
    recs = ledger_j.read_records(str(tmp_path))
    assert recs == ledger.read_records(str(tmp_path))
    assert json.loads(text.splitlines()[0])["kind"] == "meta"
