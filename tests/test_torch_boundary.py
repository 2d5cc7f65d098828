"""The port's import boundary and its device defaults.

``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax``, nor
any module of the reference package ``repro``, nor ``ml_dtypes``;
importing the port leaves them out of ``sys.modules``; and its entry points run on the
card unless the caller asks for the CPU, raising where there is none.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "jax":
            bad.append(f"jax.{node.attr}")
    assert bad == [], f"{path}: {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.deploy\n"
        "import repro_torch.convert, repro_torch.kernels.runtime\n"
        "import repro_torch.kernels.cim_mvm, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.manhattan_score, repro_torch.models.model\n"
        "import repro_torch.kernels.slstm_scan, repro_torch.kernels.bitslice_pack\n"
        "import repro_torch.models.recurrent, repro_torch.configs.xlstm_13b\n"
        "import repro_torch.checkpoint, repro_torch.serve.continuous\n"
        "import repro_torch.models.moe, repro_torch.configs.qwen2_moe_a27b\n"
        "import repro_torch.configs.mixtral_8x7b, repro_torch.mapping\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card():
    """Without device="cpu" the entry points refuse to run on a box with
    no CUDA device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.configs import CimConfig, ModelConfig
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.convert import params_from_checkpoint, params_from_numpy
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.deploy import deploy_model_params
    from repro_torch.kernels.cim_mvm import cim_mvm, cim_mvm_grouped, deploy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.bitslice_pack import bitslice_pack
    from repro_torch.kernels.manhattan_score import manhattan_score
    from repro_torch.kernels.slstm_scan import slstm_scan
    from repro_torch.models.model import init_params
    from repro_torch.nonideal import (
        NonidealModel,
        sample_cell_state,
        sample_corr_field,
        sample_line_open,
        sample_stuck,
    )
    from repro_torch.nonideal.inject import (
        matrix_cells,
        matrix_stuck,
        sample_deployment_cells,
    )
    from repro_torch.nonideal.models import generator
    from repro_torch.serve import ContinuousEngine, ServeEngine

    cfg = ModelConfig(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                      d_ff=32, vocab_size=64, dtype="float32",
                      cim=CimConfig(enabled=True, rows=16, cols=16))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dep, _ = deploy(torch.randn(16, 8), CrossbarSpec(16, 16, 8))
    x = torch.randn(2, 16)
    q = torch.randn(1, 2, 2, 16)
    pos = torch.arange(2, dtype=torch.int32)
    spec = CrossbarSpec(16, 16, 8)
    grouped = dataclasses.replace(dep, codes=dep.codes[None], pos=dep.pos[None],
                                  scale=dep.scale[None])
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    ideal, faulty = NonidealModel(), NonidealModel(p_stuck_off=0.1)
    calls = [
        lambda: ServeEngine(cfg, params, max_seq=8),
        lambda: ContinuousEngine(cfg, params, max_seq=8, max_prompt=4),
        lambda: load_checkpoint("no-such-directory"),
        lambda: params_from_checkpoint("no-such-directory", cfg),
        lambda: cim_mvm(x, dep),
        lambda: cim_mvm_grouped(x, grouped, offsets),
        lambda: flash_attention(q, q, q, q_positions=pos, k_positions=pos),
        lambda: manhattan_score(torch.zeros(1, 4, 4, dtype=torch.uint8)),
        lambda: deploy_model_params(params, cfg),
        lambda: params_from_numpy({}, cfg),
        lambda: slstm_scan(*(torch.zeros(s) for s in ((1, 1, 1, 16),
                                                      (1, 4, 16), (1, 1, 4),
                                                      (1, 1, 4)))),
        lambda: bitslice_pack(torch.zeros((2, 2), dtype=torch.int16), 8),
        lambda: generator(0),
        lambda: sample_stuck(0, (1, 4, 4), 0.1, 0.0),
        lambda: sample_line_open(0, (1, 4, 4), 0.1, 0.1),
        lambda: sample_corr_field(0, (1, 4, 4), 2.0),
        lambda: sample_cell_state(0, (1, 4, 4), ideal),
        lambda: matrix_cells(0, 0, (1, 1), spec, faulty),
        lambda: matrix_stuck(0, 0, (1, 1), spec, faulty),
        lambda: sample_deployment_cells(0, {"w": (1, 1)}, spec, faulty),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # The explicit CPU request runs the plain versions.
    assert cim_mvm(x, dep, device="cpu").shape == (2, 8)
    assert cim_mvm_grouped(x, grouped, offsets, device="cpu").shape == (2, 8)


def test_tensors_on_another_device_are_refused():
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.kernels.cim_mvm import cim_mvm, deploy

    dep, _ = deploy(torch.randn(16, 8), CrossbarSpec(16, 16, 8))
    with pytest.raises(ValueError):
        cim_mvm(torch.randn(2, 16, device="meta"), dep, device="cpu")
