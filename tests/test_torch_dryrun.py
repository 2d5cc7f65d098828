"""The port's dry-run (``repro_torch.launch.dryrun``) on ``meta``
tensors: every (arch x shape) cell of the reference's list at SMOKE
widths, the full-width phi3-mini decode_32k cell, a data-parallel
training cell and the command line.  (The per-op counter, the roofline
and the helpers are in ``test_torch_tools.py``.)
"""
import os

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import schema
from repro_torch.optim.adamw import tree_leaves

PHI3 = "phi3-mini-3.8b"


@pytest.fixture
def smoke(monkeypatch):
    """The dry-run at each arch's SMOKE widths."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: configs.get_config(arch, smoke=True))


@pytest.mark.parametrize("arch,shape", configs.arch_shape_cells())
def test_dryrun_smoke_cells_ok(arch, shape, tmp_path, smoke):
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    for key in ("memory", "params", "roofline", "wall_s", "fits"):
        assert key in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    r = rec["roofline"]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["coll_bytes"] == 0
    assert os.path.exists(tmp_path / f"{arch}__{shape}__data1.json")


def test_dryrun_full_width_phi3_decode_reports_fits(tmp_path):
    """phi3-mini at full width, decode_32k: its 32 KV heads' cache at
    128 x 32768 positions alone is 1.65 TB, so the cell does not fit one
    card; the arguments are the parameters, the state and the tokens
    exactly."""
    rec = dryrun.run_cell(PHI3, "decode_32k", out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    cfg = configs.get_config(PHI3)
    n = dryrun.param_counts(cfg)["total"]
    R, B, C = cfg.n_layers, 128, 32768
    cache = 2 * R * B * C * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert rec["memory"]["argument_bytes"] == (2 * n + cache + R * C * 4
                                               + B * 4)     # + the tokens
    assert rec["fits"] is False
    assert rec["kernels"]["flash_attention"][0] == R
    assert rec["roofline"]["dominant"] == "memory"


def test_dryrun_data_parallel_train_counts_the_reduction(tmp_path, smoke):
    rec = dryrun.run_cell(PHI3, "train_4k", data=4, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    cfg = configs.get_config(PHI3, smoke=True)
    leaves = tree_leaves(schema.abstract_params(cfg))
    payload = sum(4 * t.numel() + 4 for t in leaves)
    assert rec["roofline"]["coll_bytes"] == 4 * 2.0 * 3 / 4 * payload
    assert rec["chips"] == 4 and "tensor_parallel" in rec


def test_dryrun_cli_and_failures_recorded(tmp_path, capsys):
    dryrun.main(["--arch", PHI3, "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert "[ok]" in capsys.readouterr().out
    dryrun.main(["--arch", PHI3, "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert "[skip cached]" in capsys.readouterr().out
    rec = dryrun.run_cell(PHI3, "train_4k", data=3, out_dir=str(tmp_path))
    assert rec["ok"] is False and "does not split" in rec["error"]
    assert "traceback" in rec
