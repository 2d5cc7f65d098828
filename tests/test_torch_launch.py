"""The port's launchers (``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``) on the CPU, and the trainer's
step clock.

The serve launcher must return exactly the tokens of
``ServeEngine.generate`` on the same params and prompts (greedy, so
bit for bit); the train launcher must log finite losses under the
reference launcher's log keys, resume from its checkpoint onto the
uninterrupted run's losses (rtol 1e-5, the reference trainer's own
bound, ``tests/test_train.py``) and from the reference launcher's
checkpoint onto its losses (BF16_LOSS_RTOL), and both must refuse to
run without a card unless asked for the CPU.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import telemetry as tm
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.launch import serve as lserve
from repro_torch.launch import train as ltrain
from repro_torch.models.frontend import synthetic_embeddings
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine
from repro_torch.telemetry.report import coverage, load_spans
from repro_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
PHI3 = "phi3-mini-3.8b"
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _telemetry_reset():
    yield
    tm.disable()
    tm.trace_stop()
    tm.registry().reset()


def _engine_tokens(arch: str, batch: int, prompt: int, gen: int):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    eng = ServeEngine(cfg, params, max_seq=prompt + gen + 1, device=CPU)
    if cfg.frontend:
        prompts = synthetic_embeddings(cfg, batch, prompt,
                                       torch.Generator().manual_seed(1))
    else:
        prompts = torch.from_numpy(SyntheticTokenDataset(
            cfg.vocab_size, prompt, batch).batch_at(0)[:, :prompt])
    return eng.generate(prompts, gen)


@pytest.mark.parametrize("arch", [PHI3, "musicgen-medium", "xlstm-1.3b"])
def test_serve_launcher_returns_the_engines_tokens(arch, capsys):
    """The launcher's tokens are ``ServeEngine.generate``'s on the same
    params (generator 0) and prompts, bit for bit (a token arch, a stub
    frontend's embeddings, a recurrent arch)."""
    got = lserve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", CPU])
    assert got.shape == (2, 4) and got.dtype == torch.int32
    assert torch.equal(got, _engine_tokens(arch, 2, 8, 4))
    assert "generated 8 tokens" in capsys.readouterr().out
    assert not tm.enabled()


def test_serve_launcher_trace(tmp_path, capsys):
    """``--trace``: telemetry on for the run (off again after), the
    spans in the file with coverage >= 0.95, one request of B x gen
    tokens counted, the table printed, the tokens unchanged."""
    path = str(tmp_path / "serve.jsonl")
    got = lserve.main(["--arch", PHI3, "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3", "--device", CPU,
                       "--trace", path])
    assert not tm.enabled() and not tm.tracing()
    spans = load_spans(path)
    assert {s["name"] for s in spans} == {
        "launch/serve", "serve/generate", "serve/prefill", "serve/decode"}
    assert coverage(spans) >= 0.95
    snap = tm.registry().snapshot()
    assert snap["repro_serve_requests_total"]["values"][0]["value"] == 1
    assert snap["repro_serve_tokens_total"]["values"][0]["value"] == 6
    assert snap["repro_serve_decode_step_seconds"]["values"][0][
        "count"] == 2
    assert "serve/prefill" in capsys.readouterr().out
    assert torch.equal(got, _engine_tokens(PHI3, 2, 8, 3))


TRAIN = ["--arch", PHI3, "--smoke", "--batch", "2", "--seq", "16",
         "--lr", "1e-3"]
# The next-step loss across packages in bf16 (SMOKE phi3's dtype): the
# bound of tests/test_torch_checkpoint.py, as the packages' bf16
# forwards round differently.
BF16_LOSS_RTOL = 1e-3


def test_train_launcher_logs_and_resumes(tmp_path):
    """3 steps at the reference's log cadence (``TrainConfig.log_every``,
    so the last step): a finite loss, the reference launcher's keys and
    dt > 0, written by --metrics-out; --resume from the run's step-2
    checkpoint logs the uninterrupted run's step-3 loss."""
    out = tmp_path / "m.json"
    ckpt = str(tmp_path / "a")
    log = ltrain.main(TRAIN + ["--device", CPU, "--steps", "3",
                               "--ckpt-every", "2", "--ckpt-dir", ckpt,
                               "--metrics-out", str(out)])
    assert json.loads(out.read_text()) == log
    assert TrainConfig().log_every > 3 and [m["step"] for m in log] == [3]
    assert all(math.isfinite(m["loss"]) and m["dt"] > 0 for m in log)
    assert set(log[0]) == {"loss", "ce", "aux", "grad_norm", "clip", "lr",
                           "step", "dt"}
    resumed = ltrain.main(TRAIN + ["--device", CPU, "--steps", "3",
                                   "--resume", "--ckpt-dir", ckpt])
    assert [m["step"] for m in resumed] == [3]
    np.testing.assert_allclose(resumed[0]["loss"], log[0]["loss"],
                               rtol=LOSS_RTOL)


def test_train_launcher_keys_are_the_references(tmp_path, monkeypatch):
    """The reference launcher's log (SMOKE phi3, 3 steps) has the port's
    keys; the port's launcher resumed from the reference's step-1
    checkpoint (--resume reads its files) logs the reference's step-3
    loss within BF16_LOSS_RTOL."""
    from repro.launch import train as jtrain

    jout = tmp_path / "j.json"
    jdir = tmp_path / "j"
    monkeypatch.setattr(sys, "argv", ["train", *TRAIN, "--steps", "3",
                                      "--ckpt-every", "1", "--ckpt-dir",
                                      str(jdir), "--metrics-out", str(jout)])
    jtrain.main()
    want = json.loads(jout.read_text())
    tdir = tmp_path / "t"
    shutil.copytree(jdir / "step_00000001", tdir / "step_00000001")
    port = ltrain.main(TRAIN + ["--device", CPU, "--steps", "3",
                                "--resume", "--ckpt-dir", str(tdir)])
    assert set(want[0]) == set(port[0])
    assert [m["step"] for m in want] == [m["step"] for m in port] == [3]
    np.testing.assert_allclose(port[0]["loss"], want[0]["loss"],
                               rtol=BF16_LOSS_RTOL)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default is valid")
def test_launchers_default_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        lserve.main(["--arch", PHI3, "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ltrain.main(["--arch", PHI3, "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


def test_launchers_run_as_modules(tmp_path):
    """``python -m`` on both launchers (the command lines of the docs)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for argv in (["repro_torch.launch.serve", "--arch", PHI3, "--smoke",
                  "--batch", "1", "--prompt-len", "4", "--gen", "2",
                  "--device", CPU],
                 ["repro_torch.launch.train", "--arch", PHI3, "--smoke",
                  "--steps", "1", "--batch", "1", "--seq", "8",
                  "--device", CPU, "--ckpt-dir", str(tmp_path)]):
        res = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr


def test_default_trainer_times_its_steps(tmp_path, monkeypatch):
    """The trainer times every step on the telemetry clock: dt > 0 in
    every entry, and a stopped telemetry clock gives dt == 0."""
    cfg = get_config(PHI3, smoke=True)
    tcfg = TrainConfig(total_steps=2, log_every=1, checkpoint_every=100,
                       checkpoint_dir=str(tmp_path), async_checkpoint=False)
    ds = SyntheticTokenDataset(cfg.vocab_size, 16, 2, seed=3)
    tr = Trainer(cfg, tcfg, ds, device=CPU)
    tr.init_state()
    assert all(m["dt"] > 0 for m in tr.run(2))
    monkeypatch.setattr(tm, "monotonic", lambda: 7.0)
    tr = Trainer(cfg, tcfg, ds, device=CPU)
    tr.init_state()
    assert [m["dt"] for m in tr.run(2)] == [0.0, 0.0]
