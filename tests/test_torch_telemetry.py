"""The port's telemetry (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``), on the CPU.

Three parts:

* the reference's own contracts (``tests/test_telemetry.py``), on the
  port: exposition goldens, strict registration, the zero-allocation
  disabled path, span round trips, the report's command line, the
  pipeline's metrics and spans;
* the two packages side by side: the same declarations and recordings
  give the same Prometheus text and snapshot; either report reads
  either package's trace to the same table; the same deploy -> serve,
  continuous stream, health arc and ``mc_nf`` sweep give the same span
  names, the same recorded metric names, equal counter values and
  histogram counts (exact: they count events) and the same greedy
  tokens; ``mc_nf``'s NF mean within the solver parity bound of
  ``tests/test_torch_montecarlo.py`` (rtol 1e-3 on nf_total);
* the sync contract: tokens bit-identical with telemetry on and off,
  and ``telemetry.sync`` called only while telemetry is on.

Every test leaves both packages' telemetry off, untraced and zeroed.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtm
from repro.telemetry import report as jreport
from repro.telemetry.metrics import MetricsRegistry as JRegistry
from repro_torch import telemetry as tm
from repro_torch.telemetry import report as treport
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.report import aggregate, coverage, load_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
NF_RTOL = 1e-3      # nf_total's bound in tests/test_torch_montecarlo.py


@pytest.fixture(autouse=True)
def _telemetry_reset():
    """Every test leaves both packages off, untraced, and zeroed."""
    yield
    for pkg in (tm, jtm):
        pkg.disable()
        pkg.trace_stop()
        pkg.registry().reset()


# ------------------------------- metrics ----------------------------------


def test_counter_gauge_histogram_basic():
    tm.enable()
    reg = MetricsRegistry()
    c = reg.counter("t_ops_total", "Ops.")
    g = reg.gauge("t_depth", "Depth.")
    h = reg.histogram("t_lat_seconds", "Latency.", buckets=(0.1, 1.0))
    c.inc()
    c.inc(2)
    g.set(5.0)
    g.dec()
    h.observe(0.5)
    h.observe(1.0)  # le bounds are inclusive
    h.observe(5.0)  # overflow -> +Inf only
    snap = reg.snapshot()
    assert snap["t_ops_total"]["values"] == [{"labels": {}, "value": 3.0}]
    assert snap["t_depth"]["values"] == [{"labels": {}, "value": 4.0}]
    hv = snap["t_lat_seconds"]["values"][0]
    assert hv["counts"] == [0, 2, 1]
    assert hv["sum"] == 6.5 and hv["count"] == 3


def test_labels_create_children_and_validate():
    tm.enable()
    reg = MetricsRegistry()
    c = reg.counter("t_req_total", "Reqs.", labels=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(4)
    vals = {tuple(v["labels"].items()): v["value"]
            for v in reg.snapshot()["t_req_total"]["values"]}
    assert vals == {(("kind", "a"),): 1.0, (("kind", "b"),): 4.0}
    with pytest.raises(ValueError, match="labels"):
        c.labels(wrong="x")


def test_counter_rejects_negative_and_bad_names():
    tm.enable()
    reg = MetricsRegistry()
    c = reg.counter("t_down_total")
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    with pytest.raises(ValueError, match="bad metric name"):
        reg.counter("Bad-Name")


def test_registration_is_strict_once_only():
    reg = MetricsRegistry()
    reg.counter("t_dup_total")
    with pytest.raises(ValueError, match="register exactly once"):
        reg.gauge("t_dup_total")


def test_prometheus_exposition_golden():
    tm.enable()
    reg = MetricsRegistry()
    c = reg.counter("g_requests_total", "Requests.", labels=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    reg.gauge("g_temp", "Temp.").set(1.5)
    h = reg.histogram("g_lat_seconds", "Latency.", buckets=(0.1, 1.0))
    for v in (0.5, 1.0, 5.0):
        h.observe(v)
    assert reg.to_prometheus() == (
        "# HELP g_lat_seconds Latency.\n"
        "# TYPE g_lat_seconds histogram\n"
        'g_lat_seconds_bucket{le="0.1"} 0\n'
        'g_lat_seconds_bucket{le="1"} 2\n'
        'g_lat_seconds_bucket{le="+Inf"} 3\n'
        "g_lat_seconds_sum 6.5\n"
        "g_lat_seconds_count 3\n"
        "# HELP g_requests_total Requests.\n"
        "# TYPE g_requests_total counter\n"
        'g_requests_total{kind="a"} 3\n'
        "# HELP g_temp Temp.\n"
        "# TYPE g_temp gauge\n"
        "g_temp 1.5\n")


def test_json_snapshot_round_trips():
    tm.enable()
    reg = MetricsRegistry()
    reg.counter("t_j_total").inc(7)
    assert json.loads(reg.to_json())["t_j_total"]["values"][0][
        "value"] == 7.0


def test_reset_zeroes_values_keeps_registrations():
    tm.enable()
    reg = MetricsRegistry()
    c = reg.counter("t_r_total", labels=("k",))
    c.labels(k="x").inc(3)
    reg.reset()
    assert reg.names() == frozenset({"t_r_total"})
    assert reg.snapshot()["t_r_total"]["values"] == []
    c.labels(k="x").inc()  # children still usable after reset
    assert reg.snapshot()["t_r_total"]["values"][0]["value"] == 1.0


# --------------------------- disabled fast path ---------------------------


def test_disabled_records_nothing():
    tm.disable()
    reg = MetricsRegistry()
    c = reg.counter("t_off_total", labels=("k",))
    h = reg.histogram("t_off_seconds")
    g = reg.gauge("t_off_depth")
    c.inc()
    c.labels(k="x").inc(5)  # shared no-op child, no key created
    h.observe(1.0)
    g.set(9.0)
    snap = reg.snapshot()
    assert snap["t_off_total"]["values"] == []
    assert snap["t_off_seconds"]["values"][0]["count"] == 0
    assert snap["t_off_depth"]["values"][0]["value"] == 0.0


def test_disabled_fast_path_allocates_nothing():
    """The off path is a flag test + return: zero allocated blocks
    across 10k record calls (the reference's slack of 16 blocks for
    interpreter noise)."""
    tm.disable()
    reg = MetricsRegistry()
    c = reg.counter("t_alloc_total")
    h = reg.histogram("t_alloc_seconds")
    g = reg.gauge("t_alloc_depth")

    def burst(n):
        for _ in range(n):
            c.inc()
            h.observe(0.5)
            g.set(1.0)

    burst(1000)  # warm method caches
    gc.collect()
    before = sys.getallocatedblocks()
    burst(10000)
    gc.collect()
    assert sys.getallocatedblocks() - before <= 16


def test_disabled_overhead_smoke():
    """30k disabled record calls stay under the reference's 100 ms."""
    tm.disable()
    reg = MetricsRegistry()
    c = reg.counter("t_fast_total")
    t0 = tm.monotonic()
    for _ in range(30000):
        c.inc()
    assert tm.monotonic() - t0 < 0.1


def test_enable_after_import_activates_labels():
    """labels() taken at use time honours a later enable()."""
    tm.disable()
    reg = MetricsRegistry()
    c = reg.counter("t_late_total", labels=("k",))
    c.labels(k="x").inc()  # no-op child
    tm.enable()
    c.labels(k="x").inc()
    assert reg.snapshot()["t_late_total"]["values"][0]["value"] == 1.0


# -------------------------------- spans -----------------------------------


def test_span_noop_without_sink_or_enable(tmp_path):
    tm.enable()
    assert not tm.tracing()
    s = tm.span("x")  # no sink open
    assert s is tm.span("y")  # the shared no-op instance
    tm.trace_to(str(tmp_path / "t.jsonl"))
    tm.disable()
    assert tm.span("z") is s  # sink open but disabled


def test_span_jsonl_round_trip_and_coverage(tmp_path):
    tm.enable()
    path = tm.trace_to(str(tmp_path / "t.jsonl"))
    with tm.span("root", runs=1):
        with tm.span("child/a"):
            pass
        with tm.span("child/b", n=2):
            pass
    assert tm.trace_stop() == path
    spans = load_spans(path)
    # spans are written at exit: children first, root last
    assert [s["name"] for s in spans] == ["child/a", "child/b", "root"]
    by = {s["name"]: s for s in spans}
    assert by["root"]["parent"] is None and by["root"]["depth"] == 0
    assert by["child/a"]["parent"] == by["root"]["id"]
    assert by["child/b"]["depth"] == 1
    assert by["child/b"]["attrs"] == {"n": 2}
    assert all(s["dur"] >= 0 and s["t_end"] >= s["t_start"]
               for s in spans)
    stats, wall = aggregate(spans)
    assert wall == pytest.approx(by["root"]["dur"])
    assert coverage(spans) == pytest.approx(1.0, abs=1e-6)
    assert stats["root"]["self"] == pytest.approx(
        by["root"]["dur"] - by["child/a"]["dur"] - by["child/b"]["dur"])


def test_spans_nest_per_thread(tmp_path):
    """A span opened in another thread is a root of its own there (the
    redeploy thread's, a shard's), not a child of this thread's."""
    import threading

    tm.enable()
    path = tm.trace_to(str(tmp_path / "t.jsonl"))

    def work():
        with tm.span("thread/outer"):
            with tm.span("thread/inner"):
                pass

    with tm.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    tm.trace_stop()
    by = {s["name"]: s for s in load_spans(path)}
    assert by["thread/outer"]["parent"] is None
    assert by["thread/inner"]["parent"] == by["thread/outer"]["id"]
    assert by["main"]["parent"] is None
    assert len({s["id"] for s in by.values()}) == 3


def _report_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)


def test_trace_report_cli(tmp_path):
    tm.enable()
    path = tm.trace_to(str(tmp_path / "t.jsonl"))
    with tm.span("phase/outer"):
        with tm.span("phase/inner"):
            pass
    tm.trace_stop()
    res = _report_cli(path)
    assert res.returncode == 0, res.stderr
    assert "phase/outer" in res.stdout and "phase/inner" in res.stdout
    assert "cover" in res.stdout
    res = _report_cli("--json", path)
    data = json.loads(res.stdout)
    assert data[path]["spans"] == 2
    assert set(data[path]["phases"]) == {"phase/outer", "phase/inner"}


def test_trace_report_cli_unreadable_file_fails():
    res = _report_cli("no/such/trace.jsonl")
    assert res.returncode == 1
    assert "cannot read" in res.stderr


def test_load_spans_skips_torn_lines(tmp_path):
    p = tmp_path / "torn.jsonl"
    p.write_text('{"name": "a", "id": 0, "parent": null, "dur": 1.0}\n'
                 'not json\n'
                 '{"other": "record"}\n'
                 '{"name": "b", "id": 1, "parent": 0, "du')
    spans = load_spans(str(p))
    assert [s["name"] for s in spans] == ["a"]


# --------------------------- the two packages -----------------------------


def _record(pkg, reg) -> None:
    """One script of declarations and recordings on ``reg``."""
    c = reg.counter("x_requests_total", "Requests.", labels=("kind",))
    c.labels(kind="b").inc(2)
    c.labels(kind="a").inc()
    reg.counter("x_plain_total", "Plain.").inc(5)
    g = reg.gauge("x_depth", "Depth.")
    g.set(3.0)
    g.inc(0.25)
    g.dec()
    reg.gauge("x_level", "Level.", labels=("pool",)).labels(pool="p").set(7)
    h = reg.histogram("x_lat_seconds", "Latency.")
    for v in (1e-5, 3e-4, 0.02, 0.75, 42.0, 100.0):
        h.observe(v)
    hl = reg.histogram("x_occ", "Occupancy.", labels=("tier",),
                       buckets=(0.25, 0.5, 1.0))
    hl.labels(tier="t").observe(0.5)
    hl.labels(tier="s").observe(0.3)


@pytest.mark.parametrize("reset", [False, True])
def test_registries_expose_the_same_text_and_snapshot(reset):
    """The same declarations and recordings: equal Prometheus text and
    snapshot dicts (and after a reset, equal again)."""
    tm.enable()
    jtm.enable()
    regs = []
    for pkg, cls in ((tm, MetricsRegistry), (jtm, JRegistry)):
        reg = cls()
        _record(pkg, reg)
        if reset:
            reg.reset()
        regs.append(reg)
    t, j = regs
    assert t.to_prometheus() == j.to_prometheus()
    assert t.snapshot() == j.snapshot()
    assert t.to_json() == j.to_json()


def _write_trace(pkg, path) -> str:
    pkg.enable()
    pkg.trace_to(path)
    with pkg.span("run", n=1):
        for i in range(3):
            with pkg.span("run/step", i=i):
                with pkg.span("run/step/inner"):
                    pass
        with pkg.span("run/tail"):
            pass
    return pkg.trace_stop()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_reports_agree_on_either_packages_trace(tmp_path, writer):
    """Either package's report reads a trace of either package to the
    same records, aggregate, coverage and table."""
    path = _write_trace(tm if writer == "port" else jtm,
                        str(tmp_path / "t.jsonl"))
    spans = treport.load_spans(path)
    assert spans == jreport.load_spans(path)
    assert [s["name"] for s in spans].count("run/step") == 3
    assert set(spans[0]) == {"name", "id", "parent", "depth", "t_start",
                             "t_end", "dur"}
    assert treport.aggregate(spans) == jreport.aggregate(spans)
    assert treport.coverage(spans) == jreport.coverage(spans)
    stats, wall = treport.aggregate(spans)
    assert treport.format_table(stats, wall) == \
        jreport.format_table(stats, wall)
    assert treport.report(path) == jreport.report(path)


def _recorded(reg) -> dict:
    """Every metric with something recorded: counters and gauges by
    label values to their value, histograms to their count."""
    out = {}
    for name, m in reg.snapshot().items():
        vals = {}
        for v in m["values"]:
            key = tuple(sorted(v["labels"].items()))
            if m["kind"] == "histogram":
                if v["count"]:
                    vals[key] = v["count"]
            elif key or v["value"]:
                vals[key] = v["value"]
        if vals:
            out[name] = (m["kind"], vals)
    return out


def _start_both(tmp_path) -> None:
    for pkg, name in ((tm, "port"), (jtm, "ref")):
        pkg.enable()
        pkg.registry().reset()
        pkg.trace_to(str(tmp_path / f"{name}.jsonl"))


def _stop_both(tmp_path) -> tuple[set, set]:
    """Span names of (port, reference)."""
    names = []
    for pkg, name in ((tm, "port"), (jtm, "ref")):
        pkg.trace_stop()
        names.append({s["name"] for s in
                      load_spans(str(tmp_path / f"{name}.jsonl"))})
    return names[0], names[1]


# Recorded values that measure time or float results, not events.
_TIMES = ("repro_deploy_seconds", "repro_plan_seconds",
          "repro_serve_prefill_seconds", "repro_serve_decode_step_seconds",
          "repro_health_probe_round_seconds", "repro_mc_sweep_seconds")
_FLOATS = ("repro_mc_nf_mean", "repro_mc_nf_p95")


def _same_metrics(port: dict, ref: dict) -> None:
    """The same recorded names and kinds; equal counter values and
    histogram counts (they count events), gauges compared by caller."""
    assert set(port) == set(ref)
    for name, (kind, vals) in ref.items():
        assert port[name][0] == kind, name
        if name not in _FLOATS:
            assert port[name][1] == vals, name


def _serve_pair(tmp_path):
    """The reference's ``_serve_cfg`` engine (tests/test_telemetry.py)
    and the port's on its params, each through a fresh plan cache."""
    from repro.configs.base import CimConfig as JCim
    from repro.configs.base import ModelConfig as JModel
    from repro.deploy import PlanCache as JPlanCache
    from repro.models import model as jmodel
    from repro.serve import ServeEngine as JServe
    from repro_torch.convert import params_from_numpy
    from repro_torch.deploy import PlanCache
    from repro_torch.serve import ServeEngine
    from test_torch_serve import port_config

    jcfg = JModel(
        name="cim-telemetry-test", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
        block_pattern=("attn",), remat="none", dtype="float32",
        attn_chunk=32,
        cim=JCim(enabled=True, mode="mdm", rows=16, cols=16, n_bits=4))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device=CPU)
    with jtm.span("smoke/deploy_serve"):
        jeng = JServe(jcfg, jparams, max_seq=64,
                      plan_cache=JPlanCache(str(tmp_path / "j")))
    with tm.span("smoke/deploy_serve"):
        teng = ServeEngine(cfg, tparams, max_seq=64,
                           plan_cache=PlanCache(str(tmp_path / "t")),
                           device=CPU)
    return jeng, teng


def _prompts(seed: int = 1, shape=(2, 8)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 128, shape)


def test_deploy_serve_matches_reference(tmp_path):
    """Deploy -> serve on both packages with telemetry on: the same span
    names, recorded metric names, counter values, histogram counts and
    greedy tokens; the port's trace covers >= 95% of its wall time (the
    reference's acceptance gate)."""
    _start_both(tmp_path)
    jeng, teng = _serve_pair(tmp_path)
    p = _prompts()
    with jtm.span("smoke/generate"):
        want = np.asarray(jeng.generate(jnp.asarray(p), 3, seed=0))
    with tm.span("smoke/generate"):
        got = teng.generate(torch.from_numpy(p), 3, seed=0).numpy()
    tnames, jnames = _stop_both(tmp_path)
    np.testing.assert_array_equal(got, want)
    assert tnames == jnames
    assert {"deploy/collect", "deploy/plan", "deploy/plan_lookup",
            "deploy/plan_fused", "deploy/package", "serve/generate",
            "serve/prefill", "serve/decode"} <= tnames
    port, ref = _recorded(tm.registry()), _recorded(jtm.registry())
    _same_metrics(port, ref)
    assert port["repro_serve_requests_total"][1] == {(): 1.0}
    assert port["repro_serve_tokens_total"][1] == {(): 6.0}
    assert port["repro_deploy_matrices_total"][1][
        (("status", "deployed"),)] > 0
    assert coverage(load_spans(str(tmp_path / "port.jsonl"))) >= 0.95
    # A warm redeploy: one manifest read resolves the whole set.
    tm.registry().reset()
    jtm.registry().reset()
    _serve_pair(tmp_path)
    port, ref = _recorded(tm.registry()), _recorded(jtm.registry())
    _same_metrics(port, ref)
    assert port["repro_plan_cache_manifest_probes_total"][1] == {
        (("result", "hit"),): 1.0}


def test_continuous_stream_matches_reference(tmp_path):
    """A request stream through ``ContinuousEngine`` (capacity 2, five
    requests of mixed budgets): the same spans, counters, histogram
    counts and tokens as the reference's engine."""
    from repro.serve import ContinuousEngine as JContinuous
    from repro_torch.serve import ContinuousEngine
    from repro_torch.deploy import PlanCache
    from repro.deploy import PlanCache as JPlanCache

    jeng, teng = _serve_pair(tmp_path)
    _start_both(tmp_path)
    jc = JContinuous(jeng.cfg, jeng.params, capacity=2, max_seq=64,
                     max_prompt=16, plan_cache=JPlanCache(str(tmp_path / "j")))
    tc = ContinuousEngine(teng.cfg, teng.params, capacity=2, max_seq=64,
                          max_prompt=16,
                          plan_cache=PlanCache(str(tmp_path / "t")),
                          device=CPU)
    prompts = [_prompts(s, (1, 5 + s))[0] for s in range(5)]
    budgets = [3, 1, 4, 2, 3]
    jr = [jc.submit(p, max_tokens=n) for p, n in zip(prompts, budgets)]
    tr = [tc.submit(p, max_tokens=n) for p, n in zip(prompts, budgets)]
    jout, tout = jc.run(), tc.run()
    tnames, jnames = _stop_both(tmp_path)
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert tnames == jnames
    assert {"serve/iteration", "serve/admit", "serve/decode_batch"} <= tnames
    port, ref = _recorded(tm.registry()), _recorded(jtm.registry())
    _same_metrics(port, ref)
    assert port["repro_serve_admitted_total"][1] == {(): 5.0}
    assert port["repro_serve_evicted_total"][1] == {(): 5.0}


def test_health_arc_matches_reference(tmp_path):
    """The reference's SMOKE escalation arc (tests/test_torch_health.py's
    pair, lockstep): the same probe-round spans, probe and event
    counters by kind, hot swaps and round counts."""
    from test_torch_health import _pair

    jeng, teng = _pair(tmp_path, "serve")
    _start_both(tmp_path)
    for _ in range(4):
        jeng.check_health()
        teng.check_health()
    for dt in (1e4, 1e8, 1e4, 1e8):
        jeng.advance(dt)
        teng.advance(dt)
        jeng.check_health()
        teng.check_health()
    tnames, jnames = _stop_both(tmp_path)
    assert tnames == jnames == {"health/probe_round"}
    port, ref = _recorded(tm.registry()), _recorded(jtm.registry())
    _same_metrics(port, ref)
    events = port["repro_health_events_total"][1]
    assert {k[0][1] for k in events} >= {"trip", "recalibrate",
                                         "reprogram", "demote"}
    assert port["repro_health_probe_round_seconds"][1] == {(): 8}
    assert port["repro_serve_hot_swaps_total"][1][()] > 0


def test_mc_nf_matches_reference(monkeypatch):
    """``mc_nf`` on the reference's own conductance draws (carried into
    the port's sampler): the same samples, solves, iterations and
    unconverged counts, the NF mean within NF_RTOL, one sweep each."""
    from repro.core.tiling import CrossbarSpec as JSpec
    from repro.nonideal import models as jm
    from repro.nonideal import montecarlo as jmc
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.nonideal import models as tnm
    from repro_torch.nonideal import montecarlo as tmc

    kw = dict(sigma_program=0.05)
    masks = np.asarray((jax.random.uniform(jax.random.PRNGKey(2),
                                           (2, 16, 16)) < 0.25)
                       .astype(np.float32))
    key = jax.random.PRNGKey(0)
    g, g_ref = jmc.mc_samples(key, jnp.asarray(masks), JSpec(16, 16, 8),
                              jm.NonidealModel(**kw), 2)
    monkeypatch.setattr(tmc, "mc_samples", lambda *a, **k: (
        torch.from_numpy(np.asarray(g)), torch.from_numpy(np.asarray(g_ref))))
    tm.enable()
    jtm.enable()
    tm.registry().reset()
    jtm.registry().reset()
    want = jmc.mc_nf(masks, JSpec(16, 16, 8), jm.NonidealModel(**kw), 2,
                     key, precision="f64")
    got = tmc.mc_nf(masks, CrossbarSpec(16, 16, 8), tnm.NonidealModel(**kw),
                    2, 0, precision="f64", device=CPU)
    assert int(want.unconverged) == int(got.unconverged) == 0
    np.testing.assert_allclose(got.nf_total.numpy(),
                               np.asarray(want.nf_total), rtol=NF_RTOL)
    port, ref = _recorded(tm.registry()), _recorded(jtm.registry())
    _same_metrics(port, ref)
    assert port["repro_mc_samples_total"][1] == {(): 4.0}
    assert port["repro_solver_solves_total"][1] == {(): 1.0}
    assert port["repro_mc_sweep_seconds"][1] == {(): 1}
    for name in _FLOATS:
        np.testing.assert_allclose(port[name][1][()], ref[name][1][()],
                                   rtol=NF_RTOL, err_msg=name)


# ------------------------- the port's pipeline ----------------------------


def test_solver_metrics_count_checked_front_doors_only():
    """One checked solve counts once, the sharded front door too; an
    unchecked solve counts nothing."""
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.crossbar import (
        measured_nf_batched,
        measured_nf_batched_checked,
    )
    from repro_torch.crossbar.solver import mask_conductances
    from repro_torch.distributed import tile_sharding_ctx
    from repro_torch.distributed.solver_shard import (
        measured_nf_conductances_sharded_checked,
    )

    tm.enable()
    tm.registry().reset()
    spec = CrossbarSpec(rows=16, cols=16, n_bits=8)
    masks = (np.random.default_rng(2).random((3, 16, 16)) < 0.25) \
        .astype(np.float32)
    _, rep = measured_nf_batched_checked(masks, spec, precision="f64",
                                         device=CPU)
    measured_nf_batched(masks, spec, precision="f64", device=CPU)
    snap = tm.registry().snapshot()
    assert snap["repro_solver_solves_total"]["values"][0]["value"] == 1
    assert snap["repro_solver_iterations_total"]["values"][0][
        "value"] == rep.iterations > 0
    assert snap["repro_solver_failed_tiles_total"]["values"][0][
        "value"] == 0
    g = mask_conductances(torch.from_numpy(masks).double(), spec.r_on,
                          spec.r_off)
    measured_nf_conductances_sharded_checked(
        g, spec, precision="f64", ctx=tile_sharding_ctx(2, device=CPU),
        device=CPU)
    snap = tm.registry().snapshot()
    assert snap["repro_solver_solves_total"]["values"][0]["value"] == 2


def test_plan_cache_metrics_hit_and_miss(tmp_path):
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.deploy import PlanCache
    from repro_torch.deploy.planner import plan_matrices

    tm.enable()
    tm.registry().reset()
    spec = CrossbarSpec(rows=16, cols=16, n_bits=4)
    mats = {"m": torch.from_numpy(
        np.random.default_rng(0).standard_normal((32, 32)).astype(
            np.float32))}
    cache = PlanCache(str(tmp_path))
    _, cold = plan_matrices(mats, spec, "mdm", cache=cache)
    plan_matrices(mats, spec, "mdm", cache=cache)

    def probes(metric, result):
        vals = {tuple(v["labels"].items()): v["value"] for v in
                tm.registry().snapshot()[metric]["values"]}
        return vals.get((("result", result),), 0.0)

    assert probes("repro_plan_cache_probes_total", "miss") >= 1
    assert probes("repro_plan_cache_manifest_probes_total", "hit") >= 1
    snap = tm.registry().snapshot()
    assert snap["repro_plan_cache_puts_total"]["values"][0]["value"] >= 1
    assert snap["repro_plan_cache_read_bytes_total"]["values"][0][
        "value"] > 0
    assert snap["repro_plan_tiles_total"]["values"][0]["value"] == \
        cold["tiles_planned"] == 16
    assert snap["repro_plan_seconds"]["values"][0]["count"] == 2
    # A lazy (uncached) pass: one lookup span, one plan span a matrix.
    path = tm.trace_to(str(tmp_path / "lazy.jsonl"))
    plans, rep = plan_matrices(mats, spec, "mdm", lazy=True)
    plans.pop("m")
    tm.trace_stop()
    assert [s["name"] for s in load_spans(path)] == [
        "deploy/plan_lookup", "deploy/plan_fused"]
    assert tm.registry().snapshot()["repro_plan_tiles_total"]["values"][
        0]["value"] == 16 + rep["tiles_planned"]


# --------------------------- the sync contract ----------------------------


def test_generation_bit_identical_on_vs_off_and_sync_only_on(
        tmp_path, monkeypatch):
    """Telemetry and a sink on must not move a token, and the card is
    waited on (``telemetry.sync``) only while telemetry is on: 0 calls
    through a deploy and two generations with it off, some with it
    on."""
    from repro_torch.deploy import PlanCache
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine
    from test_torch_serve import port_config, ref_config

    calls = []
    real = tm.sync
    monkeypatch.setattr(tm, "sync", lambda d: calls.append(d) or real(d))
    cfg = port_config(ref_config("mdm"))
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    p = torch.from_numpy(_prompts())
    tm.disable()
    eng = ServeEngine(cfg, params, max_seq=32,
                      plan_cache=PlanCache(str(tmp_path / "c")), device=CPU)
    off = eng.generate(p, 4, seed=3)
    off_t = ServeEngine(cfg.replace(cim=cfg.cim.__class__()), params,
                        max_seq=32, temperature=0.7, device=CPU).generate(
                            p, 4, seed=3)
    assert calls == []
    tm.enable()
    tm.trace_to(str(tmp_path / "on.jsonl"))
    eng_on = ServeEngine(cfg, params, max_seq=32, plan_cache=False,
                         device=CPU)
    on = eng_on.generate(p, 4, seed=3)
    on_t = ServeEngine(cfg.replace(cim=cfg.cim.__class__()), params,
                       max_seq=32, temperature=0.7, device=CPU).generate(
                           p, 4, seed=3)
    assert len(calls) > 0
    assert all(torch.device(d).type == "cpu" for d in calls)
    assert torch.equal(on, off)
    assert torch.equal(on_t, off_t)
    assert torch.equal(eng.generate(p, 4, seed=3), off)


def test_sync_waits_only_on_a_cuda_device(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: waited.append(d))
    tm.sync("cpu")
    tm.sync(torch.device("cpu"))
    assert waited == []
    tm.sync("cuda:0")
    tm.sync(torch.device("cuda", 1))
    assert waited == ["cuda:0", torch.device("cuda", 1)]


def test_monotonic_and_wall_time_are_the_ports_clocks():
    import time

    assert tm.monotonic is time.perf_counter
    assert tm.wall_time is time.time
    a = tm.monotonic()
    assert tm.monotonic() >= a
