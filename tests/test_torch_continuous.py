"""The port's continuous-batching tier against the reference's (CPU).

Mirrors ``tests/test_serving_sched.py`` case for case, at its 2-layer,
d_model 32 phi3-shaped config (``CimConfig(rows=16, cols=16,
n_bits=4)`` where the crossbars are on), and holds the port to the
reference where both compute the same thing:

- scheduler bookkeeping, slot-pool state after join / evict / merge
  (every leaf) and greedy tokens: exact;
- logits, where compared: |port - reference| <= 1e-4 * max|logit|
  (``tests/test_torch_serve.py``'s bound);
- sampled tokens: the port's own counter-based stream (JAX's cannot be
  reproduced), held to row independence and to bit-identity across
  batch compositions and hot swaps, and to softmax frequencies within
  a stated statistical bound.

The receipt of fixed shapes is one call signature each for prefill,
decode, join and evict across all the churn, as the reference counts
one trace each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.deploy import PlanCache as JPlanCache
from repro.models import model as jmodel
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServeEngine as JServe
from repro.serve import SlotPool as JSlotPool
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.configs.xlstm_13b import CONFIG as XLSTM
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import PlanCache
from repro_torch.health import HealthConfig
from repro_torch.models.attention import EMPTY_POS
from repro_torch.models.model import apply_model
from repro_torch.nonideal import NonidealModel
from repro_torch.serve import (
    ContinuousEngine,
    RequestScheduler,
    ServeEngine,
    SlotPool,
    make_slot_prefill,
    sample_tokens_batch,
)

VOCAB = 128
LOGIT_RTOL = 1e-4
BF16_LOGIT_RTOL = 3e-2       # the bf16 bound of tests/test_torch_serve.py


def _jcfg(cim: bool = False) -> JModel:
    return JModel(
        name="cim-serving-sched", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, d_ff=64, vocab_size=VOCAB,
        block_pattern=("attn",), remat="none", dtype="float32",
        attn_chunk=32,
        cim=JCim(enabled=cim, mode="mdm", rows=16, cols=16, n_bits=4))


def _tcfg(jcfg: JModel) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def _params(jcfg, seed: int = 0):
    """(reference params, the port's copy on the CPU)."""
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, _tcfg(jcfg), device="cpu")


def _prompts(n, length=8, seed=5):
    rs = np.random.RandomState(seed)
    return rs.randint(0, VOCAB, size=(n, length)).astype(np.int32)


def _engine(cfg, params, tmp_path, **kw):
    kw.setdefault("capacity", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_prompt", 16)
    return ContinuousEngine(cfg, params, plan_cache=PlanCache(
        str(tmp_path / "port")), device="cpu", **kw)


# --------------------------- scheduler policy -----------------------------


def test_scheduler_fifo_admission_and_bookkeeping():
    s = RequestScheduler()
    rids = [s.submit(np.array([1, 2, 3]), max_tokens=2) for _ in range(3)]
    assert rids == [0, 1, 2]
    assert s.queue_depth == 3 and s.pending == 3
    first = s.pop_admission()
    assert first.rid == 0                    # strict FIFO
    s.start(first, slot=1, epoch=0)
    assert s.pending == 3                    # 2 queued + 1 live
    with pytest.raises(ValueError):          # occupied slot
        s.start(s.pop_admission(), slot=1, epoch=0)
    assert not s.record_token(1, 7)          # 1/2 tokens: not done
    assert s.record_token(1, 9)              # 2/2: budget hit
    seq = s.finish(1)
    assert seq.tokens == [7, 9]
    assert s.results[0] == [7, 9]
    assert 1 not in s.live
    s.start(s.pop_admission(), slot=0, epoch=3)
    assert s.epochs_live() == [3] and s.pop_admission() is None


def test_scheduler_validates_submissions():
    s = RequestScheduler()
    with pytest.raises(ValueError):
        s.submit(np.array([], np.int32), max_tokens=1)
    with pytest.raises(ValueError):
        s.submit(np.array([1]), max_tokens=0)


def test_scheduler_streams_tokens_with_done_edge():
    s = RequestScheduler()
    seen = []
    rid = s.submit(np.array([1]), max_tokens=2,
                   on_token=lambda r, t, d: seen.append((r, t, d)))
    s.start(s.pop_admission(), slot=0, epoch=0)
    s.record_token(0, 11)
    s.record_token(0, 12)
    assert seen == [(rid, 11, False), (rid, 12, True)]


# ----------------------------- slot pool ----------------------------------


def _filled_states(jpool, tpool, seed):
    """The same B=1 prefill stand-in for both pools: kpos 0..15, random
    k and v."""
    rng = np.random.default_rng(seed)
    jst, tst = jpool.fresh_seq_state(), tpool.fresh_seq_state()
    for name in (k for k in jst if k != "pos"):
        for leaf in ("k", "v", "kpos"):
            shape = jst[name][leaf].shape
            a = (np.broadcast_to(np.arange(16, dtype=np.int32), shape)
                 if leaf == "kpos"
                 else rng.standard_normal(shape).astype(np.float32))
            jst[name][leaf] = jnp.asarray(a)
            tst[name][leaf] = torch.from_numpy(np.array(a))
    return jst, tst


def _assert_pools_equal(jstate, tstate):
    assert set(jstate) == set(tstate)
    np.testing.assert_array_equal(np.asarray(jstate["pos"]),
                                  tstate["pos"].numpy())
    for name in (k for k in jstate if k != "pos"):
        for leaf, a in jstate[name].items():
            np.testing.assert_array_equal(np.asarray(a),
                                          tstate[name][leaf].numpy(),
                                          err_msg=f"{name}/{leaf}")


def test_slot_pool_join_masks_padding_and_evict_self_masks():
    jcfg = _jcfg()
    jpool = JSlotPool(jcfg, capacity=3, max_seq=16)
    pool = SlotPool(_tcfg(jcfg), capacity=3, max_seq=16, device="cpu")
    _assert_pools_equal(jpool.state, pool.state)
    slot_names = [k for k in pool.state if k != "pos"]
    for i, length in enumerate((5, 9)):
        jst, tst = _filled_states(jpool, pool, seed=i)
        assert pool.acquire() == jpool.acquire() == i   # lowest free
        jpool.join(i, jst, length=length)
        pool.join(i, tst, length=length)
        _assert_pools_equal(jpool.state, pool.state)
    pos = pool.state["pos"].numpy()
    assert pos[0] == 5 and pos[1] == 9 and pos[2] == 0
    kp = pool.state[slot_names[0]]["kpos"][:, 0].numpy()
    # The prompt's entries keep their positions; the padded tail the
    # fixed-shape prefill wrote is masked out of attention's view.
    assert np.array_equal(kp[:, :5],
                          np.broadcast_to(np.arange(5), kp[:, :5].shape))
    assert np.all(kp[:, 5:] == EMPTY_POS)
    jpool.evict(0)
    pool.evict(0)
    _assert_pools_equal(jpool.state, pool.state)
    assert pool.state["pos"][0] == 0
    assert np.all(pool.state[slot_names[0]]["kpos"][:, 0].numpy()
                  == EMPTY_POS)
    assert pool.n_free == 2 and pool.acquire() == 0
    assert pool.traces == {"join": 1, "evict": 1, "merge": 0}

    # Merge by slot mask and fork, as multi-epoch decode uses them.
    other = pool.fork()
    for sub in (v for k, v in other.items() if k != "pos"):
        for leaf in sub.values():
            leaf.add_(1)
    other["pos"] += 1
    take_b = np.array([False, True, False])
    merged = pool.merge(pool.state, other, take_b)
    jother = jax.tree_util.tree_map(lambda x: x + 1, jpool.state)
    _assert_pools_equal(jpool.merge(jpool.state, jother, take_b), merged)
    assert pool.traces["merge"] == 1
    assert not torch.equal(other["pos"], pool.state["pos"])   # a copy


def test_masked_pad_keys_are_never_attended():
    """After a padded prefill and the join, the pad tail's keys and
    values can hold anything: decode logits do not move."""
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    pool = SlotPool(cfg, capacity=2, max_seq=32, device="cpu")
    L, P = 5, 16
    prompt = torch.zeros((1, P), dtype=torch.int64)
    prompt[0, :L] = torch.from_numpy(_prompts(1, L)[0])
    st = pool.fresh_seq_state()
    zero = torch.zeros(1, dtype=torch.int64)
    with torch.no_grad():
        make_slot_prefill(cfg)(params, st, prompt, L, zero,
                               torch.zeros(1), None)
    pool.join(1, st, L)
    pool.acquire(), pool.acquire()
    tokens = torch.tensor([0, 7])[:, None]

    def decode(state):
        with torch.no_grad():
            return apply_model(params, cfg, tokens, state=state,
                               decode=True)[0][1]

    clean = decode(pool.fork())
    poisoned = pool.fork()
    for name in (k for k in poisoned if k != "pos"):
        poisoned[name]["k"][:, 1, L:P] = 1e6
        poisoned[name]["v"][:, 1, L:P] = -1e6
    assert torch.equal(decode(poisoned), clean)
    # And the lane attends exactly as an unpadded B=1 prefill would.
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    seq = torch.cat([prompt[:, :L], tokens[1:]], 1)
    ref = eng.teacher_forced_logits(seq, L)[0, 1]
    assert (clean - ref).abs().max() <= LOGIT_RTOL * ref.abs().max()


# ------------------------ engine determinism ------------------------------


@pytest.mark.parametrize("cim", [False, True])
def test_engine_greedy_matches_serve_engine(cim, tmp_path):
    """Capacity-2 continuous decode == the single-batch engine, in the
    port and in the reference, token for token."""
    jcfg = _jcfg(cim)
    cfg = _tcfg(jcfg)
    jparams, params = _params(jcfg)
    prompts = _prompts(2)
    n = 8
    jcache = JPlanCache(str(tmp_path / "ref"))
    jserve = JServe(jcfg, jparams, max_seq=64, plan_cache=jcache)
    tserve = ServeEngine(cfg, params, max_seq=64,
                         plan_cache=PlanCache(str(tmp_path / "port")),
                         device="cpu")
    jcont = JContinuous(jcfg, jparams, capacity=2, max_seq=64,
                        max_prompt=16, plan_cache=jcache)
    tcont = _engine(cfg, params, tmp_path, capacity=2)
    jrids = [jcont.submit(p, max_tokens=n) for p in prompts]
    trids = [tcont.submit(p, max_tokens=n) for p in prompts]
    jout, tout = jcont.run(), tcont.run()
    for i, p in enumerate(prompts):
        ref = list(np.asarray(jserve.generate(jnp.asarray(p[None]), n))[0])
        port = tserve.generate(torch.from_numpy(p[None]), n)[0].tolist()
        assert port == ref
        assert jout[jrids[i]] == ref
        assert tout[trids[i]] == ref, f"request {i}"
    if cim:
        assert tcont.deploy_report["manifest_hit"]   # the ServeEngine's
        for pname, d in tserve.cim["slot0_attn"].items():
            for f in ("codes", "pos", "scale"):
                assert torch.equal(getattr(d, f), getattr(
                    tcont.banks[0].cim["slot0_attn"][pname], f))


def test_bf16_engine_greedy_matches_reference(tmp_path):
    """The reference's default dtype through the continuous tier: bf16
    params, activations and slot-pool KV cache.  The port's continuous
    engine equals the port's ServeEngine token for token, and the
    reference's continuous engine up to each request's first flip; a
    flip passes only where the reference's top-2 logit gap lies inside
    the bf16 logits' bound (3e-2 * max|logit|, tests/test_torch_serve.py).
    Listed: request 2 flips at token 1, where the reference's gap is
    0.03125 (two bf16 ulps) against a logit difference of 0.03125."""
    jcfg = _jcfg(True).replace(dtype="bfloat16")
    cfg = _tcfg(jcfg)
    jparams, params = _params(jcfg)
    assert params["embed"].dtype == torch.bfloat16
    prompts, n = _prompts(3), 6
    jcache = JPlanCache(str(tmp_path / "ref"))
    jcont = JContinuous(jcfg, jparams, capacity=2, max_seq=64,
                        max_prompt=16, plan_cache=jcache)
    jserve = JServe(jcfg, jparams, max_seq=64, plan_cache=jcache)
    tcont = _engine(cfg, params, tmp_path, capacity=2)
    tserve = ServeEngine(cfg, params, max_seq=64, plan_cache=PlanCache(
        str(tmp_path / "port")), device="cpu")
    jrids = [jcont.submit(p, max_tokens=n) for p in prompts]
    trids = [tcont.submit(p, max_tokens=n) for p in prompts]
    jout, tout = jcont.run(), tcont.run()
    flips = []
    for i, p in enumerate(prompts):
        ref, port = jout[jrids[i]], tout[trids[i]]
        assert port == tserve.generate(torch.from_numpy(p[None]),
                                       n)[0].tolist()
        if port == ref:
            continue
        s = next(k for k in range(n) if port[k] != ref[k])
        seq = np.concatenate([p, ref[:s]]).astype(np.int32)[None]
        lg = _ref_logits(jserve, seq)[0, :VOCAB]   # the reference's, at s
        top = np.sort(lg)[-2:]
        flips.append((i, s, ref[s], port[s], float(top[1] - top[0])))
        assert top[1] - top[0] <= BF16_LOGIT_RTOL * np.abs(lg).max(), flips
    assert [f[:2] for f in flips] == [(2, 1)], flips


def _ref_logits(jserve, seq):
    """The reference's last-position logits after prefilling ``seq``."""
    from repro.distributed.sharding import ShardingCtx

    state = jmodel.init_decode_state(jserve.cfg, 1, jserve.max_seq)
    logits, _, _ = jmodel.apply_model(jserve.params, jserve.cfg,
                                      ShardingCtx(), tokens=jnp.asarray(seq),
                                      state=state, cim=jserve.cim)
    return np.asarray(logits[:, -1], np.float32)


def test_composition_determinism_and_single_trace(tmp_path):
    """Per-request outputs don't depend on batchmates, admission order
    or slot placement; all the churn shares one call signature each."""
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    prompts = _prompts(4)
    temps = (0.0, 0.9, 1.3, 0.7)

    def alone(i):
        eng = _engine(cfg, params, tmp_path)
        rid = eng.submit(prompts[i], max_tokens=6, temperature=temps[i],
                         seed=40 + i)
        return eng.run()[rid]

    solo = [alone(i) for i in range(4)]

    eng = _engine(cfg, params, tmp_path)
    rids = [eng.submit(prompts[i], max_tokens=6, temperature=temps[i],
                       seed=40 + i) for i in range(2)]
    eng.step()                               # stagger: 2 in flight...
    rids += [eng.submit(prompts[i], max_tokens=6, temperature=temps[i],
                        seed=40 + i) for i in range(2, 4)]
    crowd = eng.run()
    for i, rid in enumerate(rids):
        assert crowd[rid] == solo[i], f"request {i} not bit-identical"
    assert eng.traces == {"prefill": 1, "decode": 1}
    assert eng.pool.traces["join"] == 1 and eng.pool.traces["evict"] == 1
    # The sampled requests really sampled: another seed, other tokens.
    other = _engine(cfg, params, tmp_path)
    rid = other.submit(prompts[2], max_tokens=6, temperature=temps[2],
                       seed=1)
    assert other.run()[rid] != solo[2]


def test_sample_tokens_batch_is_row_independent():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((6, VOCAB))
                              .astype(np.float32))
    seeds = torch.tensor([3, 3, 9, -1, 2 ** 40, 5])
    counts = torch.tensor([0, 1, 4, 2, 7, 0])
    temps = torch.tensor([0.8, 0.8, 1.5, 0.0, 0.5, -1.0])
    out = sample_tokens_batch(logits, seeds, counts, temps)
    assert out.dtype == torch.int32
    perm = torch.tensor([5, 2, 0, 4, 1, 3])
    assert torch.equal(
        sample_tokens_batch(logits[perm], seeds[perm], counts[perm],
                            temps[perm]), out[perm])
    for b in range(6):                       # alone == within the batch
        assert sample_tokens_batch(logits[b:b + 1], seeds[b:b + 1],
                                   counts[b:b + 1], temps[b:b + 1]) == out[b]
    greedy = logits.argmax(-1).to(torch.int32)
    assert out[3] == greedy[3] and out[5] == greedy[5]
    assert out[0] != out[1] or out[0] != greedy[0]  # counts differ


def test_sample_tokens_batch_follows_softmax():
    """Draws over 4000 seeds: each token's frequency within 0.03 of its
    softmax probability (about 5 standard errors at p = 0.3)."""
    logits = torch.tensor([[1.0, 0.5, -0.3, 0.0, -2.0]]).repeat(4000, 1)
    t = 0.7
    out = sample_tokens_batch(logits, torch.arange(4000),
                              torch.full((4000,), 3),
                              torch.full((4000,), t))
    freq = torch.bincount(out.long(), minlength=5).double() / 4000
    p = torch.softmax(logits[0].double() / t, -1)
    assert (freq - p).abs().max() < 0.03, (freq, p)


# ------------------------- hot-swap atomicity -----------------------------


def test_hot_swap_mid_load_atomicity(tmp_path):
    """A mid-load async redeploy to a second checkpoint never perturbs
    in-flight sequences; a later admission serves exactly the new
    bank.  Twin engines: one swap-free, one swapping after the first
    iteration."""
    jcfg = _jcfg(cim=True)
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    _, params2 = _params(jcfg, seed=1)
    prompts = _prompts(2, seed=9)

    def fly(eng):
        rids = [eng.submit(prompts[i], max_tokens=6, temperature=0.5 * i,
                           seed=60 + i) for i in range(2)]
        eng.step()                           # both in flight, epoch 0
        return rids

    ref = _engine(cfg, params, tmp_path, capacity=2)
    ref_out = [ref.run()[r] for r in fly(ref)]

    eng = _engine(cfg, params, tmp_path, capacity=3)
    rids = fly(eng)
    late = eng.submit(_prompts(1, seed=13)[0], max_tokens=6,
                      temperature=0.7, seed=99)
    t = eng.begin_redeploy(params2)
    t.join()
    eng.run()
    assert eng.serving_epoch == 1 and list(eng.banks) == [1]
    assert eng.fanout_iterations > 0         # two epochs decoded at once
    out = [eng.results[r] for r in rids]
    assert out == ref_out                    # in flight: bit-identical
    assert all(len(x) == 6 for x in out)
    assert eng.traces == {"prefill": 1, "decode": 1}
    assert eng.pool.traces["merge"] == 1
    assert eng.deploy_report["cache_misses"] == eng.deploy_report[
        "n_matrices"]

    fresh = _engine(cfg, params2, tmp_path, capacity=3)
    assert fresh.deploy_report["manifest_hit"]
    rid = fresh.submit(_prompts(1, seed=13)[0], max_tokens=6,
                       temperature=0.7, seed=99)
    assert eng.results[late] == fresh.run()[rid]


def test_redeploy_failure_surfaces_at_the_next_step(tmp_path,
                                                   monkeypatch):
    jcfg = _jcfg(cim=True)
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    eng = _engine(cfg, params, tmp_path)

    def fail(*args):
        raise OSError("disk gone")

    monkeypatch.setattr("repro_torch.serve.continuous.deploy_serving_bank",
                        fail)
    eng.begin_redeploy(params).join()
    with pytest.raises(RuntimeError, match="redeploy"):
        eng.step()
    assert eng.serving_epoch == 0


# Stuck cells and programming variation (gain), no read noise: greedy
# decoding is then deterministic on both sides.
REDEPLOY_DEVICES = dict(p_stuck_off=0.02, p_stuck_on=0.005,
                        sigma_program=0.05)


def _with_reference_cells(monkeypatch, jcfg, trees):
    """Make the port's deploys take the cells the reference's deploy
    draws for the same (nonideal_key, pipeline), on the reference
    checkpoint ``trees[nonideal_key]``: JAX's key streams cannot be
    reproduced in torch."""
    from repro.core.tiling import CrossbarSpec as JSpec
    from repro.deploy.engine import collect_model_matrices as j_collect
    from repro.nonideal import models as jni
    from repro.nonideal.inject import sample_deployment_cells
    import repro_torch.serve.engine as tengine

    deploy = tengine.deploy_model_params
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits,
                 jcfg.cim.r, jcfg.cim.r_on, jcfg.cim.r_off)

    def with_cells(params, cfg, **kw):
        pipeline = kw["pipeline"] or cfg.cim.mode
        mats, _ = j_collect(trees[kw["nonideal_key"]], jcfg, pipeline)
        grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
        jm = jni.NonidealModel(**dataclasses.asdict(kw["nonideal"]))
        kw["cells"] = sample_deployment_cells(
            jax.random.PRNGKey(kw["nonideal_key"]), grids, spec, jm)
        return deploy(params, cfg, **kw)

    monkeypatch.setattr(tengine, "deploy_model_params", with_cells)


def test_redeploy_overrides_match_reference(tmp_path, monkeypatch):
    """A redeploy to a second checkpoint on other devices (another
    nonideal seed) under another pipeline, in the port and in the
    reference: the new bank's codes, pos and col_pos bit-identical, and
    requests admitted after the swap the same greedy tokens.  The
    engines' own settings are unchanged by the swap."""
    from repro.nonideal import models as jni

    jcfg = _jcfg(cim=True)
    cfg = _tcfg(jcfg)
    jparams, params = _params(jcfg)
    jparams2, params2 = _params(jcfg, seed=1)
    tree2 = jax.tree_util.tree_map(np.asarray, jparams2)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jm = jni.NonidealModel(**REDEPLOY_DEVICES)
    tm = NonidealModel(**REDEPLOY_DEVICES)
    _with_reference_cells(monkeypatch, jcfg, {0: tree, 3: tree2})
    jeng = JContinuous(jcfg, jparams, capacity=2, max_seq=64, max_prompt=16,
                       plan_cache=JPlanCache(str(tmp_path / "ref")),
                       nonideal=jm, nonideal_seed=0, pipeline="mdm")
    teng = _engine(cfg, params, tmp_path, capacity=2, nonideal=tm,
                   nonideal_seed=0, pipeline="mdm")
    jeng.begin_redeploy(jparams2, nonideal_seed=3,
                        pipeline="spare_line").join()
    teng.begin_redeploy(params2, nonideal_seed=3,
                        pipeline="spare_line").join()
    prompts = _prompts(2, seed=21)
    jr = [jeng.submit(p, max_tokens=6) for p in prompts]
    tr = [teng.submit(p, max_tokens=6) for p in prompts]
    jout, tout = jeng.run(), teng.run()
    assert teng.serving_epoch == jeng.serving_epoch == 1
    n_col_pos = 0
    for pname, jdep in jeng.banks[1].cim["slot0_attn"].items():
        tdep = teng.banks[1].cim["slot0_attn"][pname]
        for f in ("codes", "pos", "col_pos"):
            a, b = getattr(jdep, f), getattr(tdep, f)
            assert (a is None) == (b is None), (pname, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{pname}.{f}")
        n_col_pos += jdep.col_pos is not None
    assert n_col_pos > 0                    # spare_line's column plans
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert (teng._nonideal[1], teng._nonideal[3]) == (
        jeng._nonideal_seed, jeng._pipeline) == (0, "mdm")


def test_redeploy_keywords_inherit_engine_settings(tmp_path, monkeypatch):
    """Each keyword left unset takes the engine's own setting; one that
    is given replaces only itself."""
    jcfg = _jcfg(cim=True)
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    tm = NonidealModel(**REDEPLOY_DEVICES)
    eng = _engine(cfg, params, tmp_path, nonideal=tm, nonideal_seed=5,
                  fault_aware=False, pipeline="spare_line")
    seen = []

    def record(cfg, params, cache, device, *args):
        seen.append(args)
        return None, None, {}, None

    monkeypatch.setattr("repro_torch.serve.continuous.deploy_serving_bank",
                        record)
    eng.begin_redeploy(params).join()
    eng.step()
    other = NonidealModel(p_stuck_on=0.01)
    eng.begin_redeploy(params, nonideal=other, fault_aware=True).join()
    eng.step()
    eng.begin_redeploy(params, nonideal_seed=9, pipeline="mdm").join()
    assert seen == [(tm, 5, False, "spare_line", False, None),
                    (other, 5, True, "spare_line", False, None),
                    (tm, 9, False, "mdm", False, None)]
    assert eng._nonideal == (tm, 5, False, "spare_line")


def test_engine_rejects_oversized_prompts_and_bad_configs(tmp_path):
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    eng = _engine(cfg, params, tmp_path, capacity=1, max_seq=32,
                  max_prompt=8)
    with pytest.raises(ValueError):
        eng.submit(np.arange(9, dtype=np.int32), max_tokens=1)
    with pytest.raises(ValueError):
        _engine(cfg, params, tmp_path, capacity=1, max_seq=8, max_prompt=16)
    with pytest.raises(NotImplementedError):     # the reference's defect
        _engine(XLSTM.replace(dtype="float32"), params, tmp_path)
    # health= without a non-ideal model arms nothing (the reference's
    # tests/test_health.py::test_health_requires_nonideal_model).
    eng = _engine(cfg, params, tmp_path, health=HealthConfig())
    assert eng.health is None and eng.check_health() is None
    eng = ServeEngine(cfg, params, plan_cache=PlanCache(
        str(tmp_path / "serve")), device="cpu", health=HealthConfig())
    assert eng.health is None and eng.check_health() is None
    # Once refused, imperfect devices now serve: the same bank in both
    # engines (one seed, one cell draw), and the continuous engine's
    # greedy tokens equal the single-batch engine's.
    jcfg = _jcfg(True)
    cfg = _tcfg(jcfg)
    _, params = _params(jcfg)
    model = NonidealModel(p_stuck_off=0.02, p_stuck_on=0.01,
                          sigma_program=0.05)
    cont = _engine(cfg, params, tmp_path, capacity=2, nonideal=model,
                   nonideal_seed=3)
    serve = ServeEngine(cfg, params, max_seq=64, nonideal=model,
                        nonideal_seed=3, plan_cache=PlanCache(
                            str(tmp_path / "port")), device="cpu")
    assert cont.deploy_report["nonideal"] and serve.deploy_report["nonideal"]
    for pname, d in serve.cim["slot0_attn"].items():
        for f in ("codes", "pos", "gain"):
            assert torch.equal(getattr(d, f), getattr(
                cont.banks[0].cim["slot0_attn"][pname], f)), (pname, f)
    prompts = _prompts(2)
    rids = [cont.submit(p, max_tokens=6) for p in prompts]
    out = cont.run()
    for rid, p in zip(rids, prompts):
        assert out[rid] == serve.generate(torch.from_numpy(p[None]),
                                          6)[0].tolist()


def test_launch_counts_hold_under_threads():
    """The background redeploy launches kernels beside the serving
    thread: no count is lost with more threads than cores switching
    every microsecond."""
    import os
    import sys
    import threading

    from repro_torch.kernels import runtime

    n_threads, per = 2 * (os.cpu_count() or 1) + 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runtime.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            runtime.count_launch("cim_mvm") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert runtime.launch_counts()["cim_mvm"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        runtime.reset_launch_counts()
