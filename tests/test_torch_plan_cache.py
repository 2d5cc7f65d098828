"""The port's plan cache against the reference's (CPU).

Tolerances: none.  Fingerprints, plan keys and manifest keys are equal
strings; plans read back (``row_perm``, ``row_position``, ``nf_before``,
``nf_after``, ``scale``, dataflow) and deployments (``codes``, ``pos``,
``scale``) are bit-identical.  Entries written by either package are
read by the other: the binary format is one.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.deploy import PlanCache as JPlanCache
from repro.deploy import manifest_key as j_manifest_key
from repro.deploy import weight_fingerprint as j_weight_fingerprint
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.deploy.engine import spec_from_config as j_spec
from repro.deploy.planner import fingerprint_matrices as j_fingerprints
from repro.deploy.planner import plan_matrices as j_plan_matrices
from repro.mapping import MappingPipeline as JPipeline
from repro.mapping import XChangrCols
from repro.models import model as jmodel
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.mdm import MODES
from repro_torch.deploy import (
    PlanCache,
    collect_model_matrices,
    deploy_model_params,
    fingerprint_matrices,
    manifest_key,
    plan_matrices,
    spec_from_config,
    weight_fingerprint,
)

PLAN_FIELDS = ("row_perm", "row_position", "nf_before", "nf_after", "scale")


def _configs(mode="mdm"):
    jcfg = JModel(name="cache-test", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab_size=128,
                  block_pattern=("attn",), remat="none", dtype="float32",
                  attn_chunk=32,
                  cim=JCim(enabled=True, mode=mode, rows=16, cols=16,
                           n_bits=4))
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "block_pattern", "dtype", "attn_chunk")},
        cim=CimConfig(enabled=True, mode=mode, rows=16, cols=16, n_bits=4))
    return jcfg, tcfg


def _matrices(mode="mdm", seed=0):
    jcfg, tcfg = _configs(mode)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    jmats, _ = j_collect(tree, jcfg, mode)
    tmats, _ = collect_model_matrices(tparams, tcfg)
    return jcfg, tcfg, jmats, tmats, tparams


def _assert_plans_equal(jplan, tplan, name):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jplan, f)),
                                      getattr(tplan, f).cpu().numpy(),
                                      err_msg=f"{name}.{f}")
    assert bool(jplan.reversed_dataflow) == bool(tplan.reversed_dataflow)


@pytest.mark.parametrize("mode", MODES)
def test_keys_equal_the_reference(mode):
    jcfg, tcfg, jmats, tmats, _ = _matrices(mode)
    assert list(jmats) == list(tmats)
    for name in jmats:
        assert (weight_fingerprint(tmats[name])
                == j_weight_fingerprint(jmats[name])), name
    assert list(spec_from_config(tcfg)) == list(j_spec(jcfg))
    tkeys = fingerprint_matrices(tmats, spec_from_config(tcfg), mode)
    jkeys = j_fingerprints(jmats, j_spec(jcfg), mode)
    assert tkeys == jkeys
    assert manifest_key(tkeys) == j_manifest_key(jkeys)


@pytest.mark.parametrize("mode", MODES)
def test_port_writes_reference_reads(mode, tmp_path):
    jcfg, tcfg, jmats, tmats, _ = _matrices(mode)
    cache = PlanCache(str(tmp_path))
    plans, rep = plan_matrices(tmats, spec_from_config(tcfg), mode, cache)
    assert rep["cache_misses"] == len(tmats) and not rep["manifest_hit"]
    keys = fingerprint_matrices(tmats, spec_from_config(tcfg), mode)
    ref = JPlanCache(str(tmp_path))
    manifest = ref.get_manifest(keys)
    assert manifest is not None
    for name, key in keys.items():
        _assert_plans_equal(ref.get(key), plans[name], name)
        _assert_plans_equal(manifest[name], plans[name], name)
    assert ref.stats.misses == 0


@pytest.mark.parametrize("mode", MODES)
def test_reference_writes_port_reads(mode, tmp_path):
    jcfg, tcfg, jmats, tmats, _ = _matrices(mode)
    jplans, _ = j_plan_matrices(jmats, j_spec(jcfg), mode,
                                cache=JPlanCache(str(tmp_path)))
    keys = fingerprint_matrices(tmats, spec_from_config(tcfg), mode)
    cache = PlanCache(str(tmp_path))
    manifest = cache.get_manifest(keys)
    assert manifest is not None
    for name, key in keys.items():
        _assert_plans_equal(jplans[name], cache.get(key), name)
        _assert_plans_equal(jplans[name], manifest[name], name)
    plans, rep = plan_matrices(tmats, spec_from_config(tcfg), mode, cache)
    assert rep["manifest_hit"] and rep["cache_misses"] == 0
    assert rep["tiles_planned"] == 0
    assert all(p.row_perm.device.type == "cpu" for p in plans.values())


def test_column_plans_of_the_reference_are_misses(tmp_path):
    """Once misses, now hits: a non-legacy reference pipeline stores
    column plans (flags bit 1), and the port decodes every entry and the
    manifest, column permutations included, equal to the reference's;
    its own keys for the pipeline are the reference's."""
    jcfg, tcfg, jmats, tmats, _ = _matrices()
    pipe = JPipeline(cols=XChangrCols())
    j_plan_matrices(jmats, j_spec(jcfg), pipe,
                    cache=JPlanCache(str(tmp_path)))
    keys = j_fingerprints(jmats, j_spec(jcfg), pipe)
    assert fingerprint_matrices(tmats, spec_from_config(tcfg),
                                "xchangr") == keys
    ref = JPlanCache(str(tmp_path))
    cache = PlanCache(str(tmp_path))
    plans = cache.get_manifest(keys)
    assert plans is not None and cache.stats.manifest_hits == 1
    for name, key in keys.items():
        want, got = ref.get(key), cache.get(key)
        assert got.col_perm is not None
        for p in (got, plans[name]):
            for f in ("row_perm", "row_position", "col_perm",
                      "col_position", "nf_before", "nf_after"):
                np.testing.assert_array_equal(getattr(p, f).numpy(),
                                              np.asarray(getattr(want, f)))
    assert cache.stats.misses == 0


@pytest.mark.parametrize("damage", ["torn", "trailing", "header"])
def test_damaged_entries_are_misses(damage, tmp_path):
    _, tcfg, _, tmats, _ = _matrices()
    spec = spec_from_config(tcfg)
    plan_matrices(tmats, spec, "mdm", PlanCache(str(tmp_path)))
    keys = fingerprint_matrices(tmats, spec, "mdm")
    key = next(iter(keys.values()))
    cache = PlanCache(str(tmp_path))
    path = cache._path(key)
    with open(path, "rb") as f:
        buf = f.read()
    buf = {"torn": buf[:-3], "trailing": buf + b"\0",
           "header": bytes([buf[0], 99]) + buf[2:]}[damage]
    with open(path, "wb") as f:
        f.write(buf)
    assert cache.get(key) is None
    assert JPlanCache(str(tmp_path)).get(key) is None
    # The manifest still resolves every plan in one read; without it the
    # damaged entry is replanned and rewritten.
    assert cache.get_manifest(keys) is not None
    for p in (tmp_path / "manifest").rglob("*.mdmmanifest"):
        os.remove(p)
    _, rep = plan_matrices(tmats, spec, "mdm", cache)
    assert rep["cache_misses"] == 1
    assert cache.get(key) is not None


def test_second_deploy_hits_the_manifest(tmp_path):
    _, tcfg, _, _, tparams = _matrices()
    cache = PlanCache(str(tmp_path))
    cim1, rep1 = deploy_model_params(tparams, tcfg, cache=cache,
                                     device="cpu")
    cim2, rep2 = deploy_model_params(tparams, tcfg, cache=cache,
                                     device="cpu")
    cim0, rep0 = deploy_model_params(tparams, tcfg, device="cpu")
    n = rep0["n_matrices"]
    assert (rep1["cache_misses"], rep1["manifest_hit"]) == (n, False)
    assert (rep2["cache_hits"], rep2["manifest_hit"]) == (n, True)
    assert rep2["tiles_planned"] == 0 and rep2["tiles"] == rep0["tiles"]
    assert rep0["tiles_planned"] == rep0["tiles"] and not rep0["manifest_hit"]
    assert rep2["nf_after"] == pytest.approx(rep0["nf_after"], rel=1e-12)
    assert cache.stats.puts == n and cache.bytes_written > 0
    for slot, deps in cim0.items():
        for pname, d0 in deps.items():
            for cim in (cim1, cim2):
                for f in ("codes", "pos", "scale"):
                    assert torch.equal(getattr(cim[slot][pname], f),
                                       getattr(d0, f)), (slot, pname, f)


def test_changed_matrix_replans_only_itself(tmp_path):
    _, tcfg, _, tmats, _ = _matrices()
    spec = spec_from_config(tcfg)
    cache = PlanCache(str(tmp_path))
    plan_matrices(tmats, spec, "mdm", cache)
    name = next(iter(tmats))
    changed = dict(tmats, **{name: tmats[name] * 2 + 1})
    _, rep = plan_matrices(changed, spec, "mdm", cache)
    assert not rep["manifest_hit"]
    assert (rep["cache_hits"], rep["cache_misses"]) == (len(tmats) - 1, 1)
