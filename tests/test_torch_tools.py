"""The reference's tools on the port: the dry-run's cells and parameter
counts, the per-op cost counter against ``repro.launch.hlo_cost``, the
roofline, the mesh, and the helpers the port lacked (bit-slice,
Manhattan and MDM helpers, ``register_pipeline``, ``plan_model_tiles``,
``collect_projection_matrices``, ``deploy_matrices``, ``embedding_spec``,
``abstract_params``), each bit for bit against the reference where the
reference computes it.

Inputs are made from a seed with numpy (reference parameters carried
across with ``repro_torch.convert``); the port runs on the CPU and on
``meta`` tensors.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.bitslice import bitslice as j_bitslice
from repro.core.bitslice import column_density as j_column_density
from repro.core.bitslice import quantization_error_bound as j_error_bound
from repro.core import manhattan as jman
from repro.core import mdm as jmdm
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import engine as jengine
from repro.deploy import planner as jplanner
from repro.distributed.sharding import ShardingCtx
from repro.launch import hlo_cost
from repro.mapping import pipeline as jpipe
from repro.models import frontend as jfrontend
from repro.models import model as jmodel
from repro.models import schema as jschema
from repro.serve.engine import make_prefill
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import bitslice, manhattan, mdm
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy import (
    collect_projection_matrices,
    deploy_matrices,
    plan_model_tiles,
)
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.slstm_scan import ops as slstm
from repro_torch.launch import dryrun, mesh, op_cost, perf, roofline
from repro_torch.mapping import MappingPipeline, XChangrCols, pipeline
from repro_torch.models import frontend, schema
from repro_torch.models.model import PLAIN, apply_model, init_decode_state
from repro_torch.optim.adamw import tree_leaves

SPEC = (16, 16, 4)
PHI3 = "phi3-mini-3.8b"


def _w(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _same(a, b, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _reference_import(name: str):
    """Import a reference launch module that sets XLA_FLAGS at import
    (its 512 placeholder devices), leaving the environment as it was."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return __import__(f"repro.launch.{name}", fromlist=[name])
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ------------------------------------------------------------ configs

def test_shapes_and_cells_match_reference():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in configs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jconfigs.SHAPES[name])
    assert configs.arch_shape_cells() == jconfigs.arch_shape_cells()
    assert len(configs.arch_shape_cells()) == 33
    for arch in configs.ARCHS:
        for smoke in (False, True):
            c = configs.get_config(arch, smoke)
            j = jconfigs.get_config(arch, smoke)
            assert c.is_recurrent_only == j.is_recurrent_only, arch
            assert c.supports_long_context == j.supports_long_context, arch


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("shape,seed", [((48, 6), 0), ((70, 13), 1),
                                         ((100, 23), 2)])
def test_bitslice_helpers_bit_identical(shape, seed, n_bits):
    w = _w(shape, seed)
    got = bitslice.bitslice(torch.from_numpy(w), n_bits)
    want = j_bitslice(jnp.asarray(w), n_bits)
    _same(bitslice.column_density(got.bits), j_column_density(want.bits),
          "column_density")
    _same(bitslice.quantization_error_bound(got.scale, n_bits),
          j_error_bound(want.scale, n_bits), "bound")


@pytest.mark.parametrize("J,K,p,seed", [(16, 16, 0.3, 0), (8, 8, 0.6, 1),
                                        (64, 64, 0.2, 2), (12, 12, 0.5, 3)])
def test_manhattan_helpers_bit_identical(J, K, p, seed):
    m = (np.random.default_rng(seed).uniform(size=(5, J, K)) < p).astype(
        np.float32)
    _same(manhattan.placement_cost(torch.from_numpy(m)),
          jman.placement_cost(jnp.asarray(m)), "placement_cost")
    mirror = manhattan.antidiagonal_mirror(torch.from_numpy(m))
    _same(mirror.contiguous(), jman.antidiagonal_mirror(jnp.asarray(m)))
    nf = lambda a: manhattan.nonideality_factor(a, 2.5, 300e3)
    _same(nf(torch.from_numpy(m)), nf(mirror), "mirror keeps the NF")


@pytest.mark.parametrize("mode", ["baseline", "mdm"])
def test_permute_inputs_bit_identical(mode):
    w = _w((40, 24), 5)
    tp = mdm.plan_layer(torch.from_numpy(w), CrossbarSpec(*SPEC), mode)
    jp = jmdm.plan_layer(jnp.asarray(w), JSpec(*SPEC), mode)
    x = _w((3, 16), 6)
    for ti in range(tp.row_perm.shape[0]):
        for tn in range(tp.row_perm.shape[1]):
            _same(mdm.permute_inputs(torch.from_numpy(x), tp, ti, tn),
                  jmdm.permute_inputs(jnp.asarray(x), jp, ti, tn))


def test_register_pipeline_as_the_reference():
    name = "tools-test-xchangr"
    pipe = MappingPipeline(cols=XChangrCols())
    jpipe_ = jpipe.MappingPipeline(cols=jpipe.XChangrCols())
    try:
        assert pipeline.register_pipeline(name, pipe) is pipe
        jpipe.register_pipeline(name, jpipe_)
        assert pipeline.resolve_pipeline(name) is pipe
        with pytest.raises(ValueError) as got:
            pipeline.register_pipeline(name, MappingPipeline())
        with pytest.raises(ValueError) as want:
            jpipe.register_pipeline(name, jpipe.MappingPipeline())
        assert str(got.value) == str(want.value)
        base = MappingPipeline()
        assert pipeline.register_pipeline(name, base, override=True) is base
        assert pipeline.named_pipelines()[name] is base
    finally:
        pipeline._NAMED.pop(name, None)
        jpipe._NAMED.pop(name, None)


def _smoke_phi3(seed: int = 0):
    """SMOKE phi3 in f32 on both packages: (ref cfg, ref params, port
    cfg, port params on the CPU)."""
    jcfg = jconfigs.get_config(PHI3, smoke=True).replace(dtype="float32")
    cfg = configs.get_config(PHI3, smoke=True).replace(dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, cfg, params_from_numpy(tree, cfg, device="cpu")


def test_collect_and_plan_model_tiles_match_reference():
    jcfg, jp, cfg, tp = _smoke_phi3()
    want = jengine.collect_projection_matrices(jp, jcfg)
    got = collect_projection_matrices(tp, cfg)
    assert list(got) == list(want)
    for name in want:
        _same(got[name].contiguous(), want[name].astype(np.float32), name)
    for spec in ((16, 16, 4), (64, 64, 8), (32, 16, 8)):
        assert plan_model_tiles(got, CrossbarSpec(*spec)) \
            == jplanner.plan_model_tiles(want, JSpec(*spec))


@pytest.mark.parametrize("mode", ["mdm", "xchangr"])
@pytest.mark.parametrize("cached", [False, True])
def test_deploy_matrices_bit_identical(mode, cached, tmp_path):
    from repro.deploy import PlanCache as JCache
    from repro_torch.deploy import PlanCache

    jcfg, jp, cfg, tp = _smoke_phi3(1)
    want_m = jengine.collect_projection_matrices(jp, jcfg)
    got_m = collect_projection_matrices(tp, cfg)
    jdeps, jrep = jengine.deploy_matrices(
        want_m, JSpec(*SPEC), mode, cache=JCache(str(tmp_path / "j"))
        if cached else None)
    deps, rep = deploy_matrices(
        got_m, CrossbarSpec(*SPEC), mode, cache=PlanCache(
            str(tmp_path / "t")) if cached else None)
    for k in ("n_matrices", "cache_hits", "cache_misses", "manifest_hit",
              "tiles_planned"):
        assert rep[k] == jrep[k], k
    assert list(deps) == list(jdeps)
    for name, d in deps.items():
        j = jdeps[name]
        _same(d.codes, np.asarray(j.codes), f"{name} codes")
        _same(d.pos, np.asarray(j.pos), f"{name} pos")
        _same(d.scale, np.asarray(j.scale), f"{name} scale")
        assert (d.reversed_df, d.eta, d.in_dim, d.out_dim) == (
            bool(j.reversed_df), j.eta, j.in_dim, j.out_dim)
        if j.col_pos is not None:
            _same(d.col_pos, np.asarray(j.col_pos), f"{name} col_pos")


def test_embedding_spec_and_abstract_params_match_reference():
    for arch in ("internvl2-76b", "musicgen-medium"):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        got = frontend.embedding_spec(cfg, 4, 128)
        want = jfrontend.embedding_spec(jcfg, 4, 128)
        assert got.device.type == "meta"
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert frontend.embedding_spec(cfg, 2, 8, torch.float32).dtype \
            == torch.float32
    for arch in configs.ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        got = tree_leaves(schema.abstract_params(cfg))
        want = jax.tree_util.tree_leaves(jschema.abstract_params(jcfg))
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        assert {t.device.type for t in got} == {"meta"}


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_counts_match_reference(arch):
    """At full width, from each package's abstract schema (nothing
    compiled, nothing allocated)."""
    jdry = _reference_import("dryrun")
    got = dryrun.param_counts(configs.get_config(arch))
    want = jdry.param_counts(jconfigs.get_config(arch))
    assert got == want
    assert type(got["active"]) is type(want["active"])


# ------------------------------------------------------------ counter

def test_plain_matmul_flops_exact():
    """The reference's hlo_cost case: a @ b counts 2 M N K exactly."""
    a = torch.empty((64, 128), device="meta")
    b = torch.empty((128, 32), device="meta")
    res = op_cost.analyze(lambda: a @ b)
    assert res.flops == 2 * 64 * 128 * 32
    assert res.bytes_accessed == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert list(res.ops) == ["mm"]


def test_layer_flops_scale_with_depth():
    """The reference's scan case: tanh(c @ w) over R layers, R = 2 -> 8
    gives 4x the operations (eager: no trip counts to recover)."""
    def step(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    x = torch.empty((128, 256), device="meta")
    flops = {}
    for R in (2, 8):
        ws = torch.empty((R, 256, 256), device="meta").unbind(0)
        res = op_cost.analyze(step, ws, x)
        flops[R] = res.flops
        assert flops[R] >= 2 * 128 * 256 * 256 * R
    assert flops[8] == 4 * flops[2]


def test_live_bytes_count_a_storage_once():
    x = torch.empty((1024,), device="meta")

    def step(x):
        y = x * 2                  # 4 KB
        v = y.view(32, 32)         # a view: nothing new
        y.mul_(3)                  # in place: nothing new
        z = v + 1                  # 4 KB
        del y, v
        return z

    res = op_cost.analyze(step, x)
    assert res.peak_bytes == 8192
    assert res.end_bytes == 4096


def _smoke_cim_phi3():
    cfg = configs.get_config(PHI3, smoke=True)
    cfg = cfg.replace(dtype="float32", cim=configs.CimConfig(
        enabled=True, mode="mdm", rows=16, cols=16, n_bits=4))
    from repro_torch.deploy import deploy_model_params
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cim, _ = deploy_model_params(params, cfg, device="cpu")
    return cfg, params, cim


def _prefill_decode(cfg, params, cim, ops, device, B=2, S=12, C=16):
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(device)
    state = init_decode_state(cfg, B, C, device)
    with op_cost.OpCost(0) as c:
        _, state = apply_model(params, cfg, toks[:, :S], state=state,
                               cim=cim, ops=ops)
        c.pos0 = S
        apply_model(params, cfg, toks[:, S:], state=state, decode=True,
                    cim=cim, ops=ops)
        return c.result()


def _table(rows: dict) -> dict:
    return {k: r.as_tuple() for k, r in rows.items()}


def test_counted_plain_equals_cost_ops_on_meta():
    """A SMOKE phi3 CIM prefill and one decode step: counted(PLAIN) on
    the CPU and COST_OPS on meta give the same table, op by op and
    kernel by kernel, and the same live bytes."""
    cfg, params, cim = _smoke_cim_phi3()
    # A served engine's deployments hold their per-layer views already
    # (made once, at its first forward); the meta copies make them now.
    _prefill_decode(cfg, params, cim, PLAIN, "cpu")
    cpu = _prefill_decode(cfg, params, cim, op_cost.counted(PLAIN), "cpu")
    meta = _prefill_decode(cfg, op_cost.to_meta(params),
                           op_cost.to_meta(cim), op_cost.COST_OPS, "meta")
    assert _table(cpu.kernels) == _table(meta.kernels)
    assert _table(cpu.ops) == _table(meta.ops)
    assert (cpu.peak_bytes, cpu.end_bytes) == (meta.peak_bytes,
                                               meta.end_bytes)
    n_mats = 7 * cfg.n_layers
    assert cpu.kernels["cim_mvm"].count == 2 * n_mats
    assert cpu.kernels["flash_attention"].count == 2 * cfg.n_layers


def test_flash_rule_counts_the_visible_pairs():
    """flash.visible against the masks the positions make."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        C = int(rng.integers(1, 40))
        S = int(rng.integers(1, 2 * C))
        pos0 = int(rng.integers(0, 3 * C))
        window = int(rng.choice([0, 1, 3, 7, 64]))
        written = np.arange(pos0 + S)
        kept = written[written >= pos0 + S - C]
        q = np.arange(pos0, pos0 + S)[:, None]
        mask = (kept[None] <= q) & ((q - kept[None] < window) if window
                                    else True)
        assert flash.visible(pos0, S, C, window) == (
            int(mask.sum()), int(mask.any(0).sum())), (pos0, S, C, window)


def _meta_dep(I, N, folded=False, noise=False):
    """A deployment of an (I, N) matrix at 64x64x8 as meta tensors: the
    rules read shapes alone."""
    from repro_torch.kernels.cim_mvm import ops as cim

    m = lambda *shape, dt=torch.int16: torch.empty(shape, dtype=dt,
                                                    device="meta")
    dep = cim.CimDeployment(
        codes=m(I, N), pos=m(I, N // 8, dt=torch.int32),
        scale=m(dt=torch.float32), n_bits=8, wpt=8, cols=64, eta=2e-3,
        reversed_df=True, in_dim=I, out_dim=N,
        noise_tag=torch.tensor(3, dtype=torch.int32) if noise else None,
        sigma_read=0.01 if noise else 0.0)
    if folded:
        dep.folded = m(I, cim.folded_ld(N), dt=torch.float32)
    return dep


def test_kernel_rules_match_the_recorded_bounds():
    """Bounds PERF.md section 6 records (rows 1a-1d, 2b, 3, 4, 5b, 7, in
    ms), from the rules and the shapes alone."""
    from repro_torch.kernels.bitslice_pack import ops as pack
    from repro_torch.kernels.cim_mvm import ops as cim
    from repro_torch.kernels.line_solve import ops as line
    from repro_torch.kernels.manhattan_score import ops as score

    ms = lambda c: (round(c.bound()[0] * 1e3, 4), c.bound()[1])
    dep = _meta_dep(3072, 8192)
    assert ms(cim.cost(4, dep)) == (0.0188, "bytes")                 # 1a
    assert ms(cim.cost(512, dep)) == (0.1562, "operations")          # 1b
    noisy = _meta_dep(3072, 8192, folded=True, noise=True)
    assert ms(cim.cost(4, noisy, True, True)) == (0.0301, "bytes")   # 1c
    assert ms(cim.cost(512, noisy, True, True)) == (0.1041,
                                                    "operations")    # 1d
    pairs, seen = flash.visible(158, 1, 160)     # the decode case, 2b
    assert ms(flash.cost(4, 1, 32, 32, 96, False, 4 * pairs, 4 * seen,
                         1 + 160)) == (0.0047, "bytes")
    assert ms(score.cost(49152, 64, 64)) == (0.0677, "bytes")        # 3
    assert ms(pack.cost(3072 * 32128, 8)) == (0.3535, "bytes")       # 4
    assert ms(slstm.cost(4, 128, 4, 512, 2, 2, 4, slstm.FORM_SCAN)) \
        == (0.0130, "operations")                                    # 5b
    assert ms(line.cost(49152, 64, 64)) == (2.4039, "bytes")         # 7


def test_against_hlo_cost_dot_flops():
    """The dot operations of a SMOKE phi3 prefill: the port's counted
    mm / bmm (the plain attention's chunked einsums over every key, as
    the reference's XLA attention computes them) against the dots of
    the reference's compiled prefill, walked by ``hlo_cost``: equal."""
    jcfg = jconfigs.get_config(PHI3, smoke=True).replace(dtype="float32")
    cfg = configs.get_config(PHI3, smoke=True).replace(dtype="float32")
    B, S = 2, 32
    prefill = make_prefill(jcfg, ShardingCtx())
    jp = jschema.abstract_params(jcfg)
    jst = jmodel.init_decode_state(jcfg, B, S, abstract=True)
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    hlo = jax.jit(lambda p, st, x: prefill(p, st, x, jax.random.PRNGKey(0))
                  ).lower(jp, jst, toks).compile().as_text()
    comps = hlo_cost.parse_computations(hlo)
    mult = hlo_cost._multipliers(comps)
    want = sum(mult.get(name, 0.0) * hlo_cost._dot_flops(op, comp)
               for name, comp in comps.items() if name != "__entry__"
               for op in comp.ops if op.opcode == "dot")
    state = init_decode_state(cfg, B, S, "meta")
    res = op_cost.analyze(
        apply_model, schema.abstract_params(cfg), cfg,
        torch.empty((B, S), dtype=torch.int32, device="meta"), state=state,
        ops=PLAIN)
    got = sum(res.ops[k].flops for k in ("mm", "bmm") if k in res.ops)
    assert got == want


def test_perf_variants_cover_the_reference():
    jperf = _reference_import("perf")
    assert list(perf.ITERATIONS) == list(jperf.ITERATIONS)
    fields = {f.name for f in dataclasses.fields(configs.ModelConfig)}
    for cell, iters in jperf.ITERATIONS.items():
        ported = [t for t, _, _ in perf.ITERATIONS[cell]]
        want = [t for t, _, _ in iters]
        assert set(ported) | set(perf.NOT_PORTED[cell]) >= set(want)
        for tag, overrides, _ in perf.ITERATIONS[cell]:
            assert set(overrides) <= fields, tag
        for tag, overrides, _ in iters:
            if tag in perf.NOT_PORTED[cell]:
                assert not set(overrides) <= fields, tag


# ------------------------------------------------------------ roofline, mesh

def test_roofline_terms():
    r = roofline.Roofline(flops=989e12, bytes_accessed=3.35e12,
                          coll_bytes=0.0, chips=1, model_flops=989e12,
                          peak_flops=roofline.PEAK_BF16)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == 1.0
    keys = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "useful_flop_ratio", "roofline_fraction"}
    assert keys <= set(r.as_dict())
    assert roofline.bound(67e12, 1.0) == (1.0, "operations")
    assert roofline.bound(1.0, 3.35e12) == (1.0, "bytes")
    assert roofline.peak_for(torch.float32) == 67e12
    assert roofline.peak_for(torch.bfloat16) == 989e12
    c = roofline.Cost(0.0, roofline.PEAK_TF32, 0.0, 67e12)
    assert c.bound() == (1.0, "operations")


def test_mesh_raises_without_enough_cards():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="need"):
        mesh.make_production_mesh(n + 1)
    if n == 0:
        with pytest.raises(RuntimeError):
            mesh.make_smoke_mesh()
