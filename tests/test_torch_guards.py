"""Guards of the port rule: the PyTorch package and chip_smoke.py import no
JAX and nothing of the reference package; asking for CUDA without a card
raises instead of running on the CPU; the port's parameters have exactly
the reference's keys and shapes."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.lm import lm_param_defs as j_lm_param_defs

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax_or_reference():
    """A fresh interpreter imports every port module and chip_smoke.py and
    finds no jax* or repro* module loaded."""
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=1,
                              d_model=64, num_heads=2, num_kv_heads=1,
                              d_ff=128, vocab_size=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)          # the default device is the card


@pytest.mark.parametrize("arch", ["whisper-base", "bert-110m"])
def test_encoder_families_default_to_the_card(arch):
    """The encoder-decoder and the encoder are built on the card unless the
    caller asks for the CPU: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = get_config(arch, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, mode="reference", device="cuda")


def test_launcher_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])


def test_training_entry_points_default_to_the_card():
    """launch/train.py and the data iterator run on the card unless the
    caller asks for the CPU: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataIterator(DataConfig(vocab_size=8, seq_len=4, global_batch=1))


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    proc = subprocess.run([sys.executable, str(CHIP_SMOKE)],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory holding nothing else of the repo, the script
    cannot find the port and fails."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(CHIP_SMOKE.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("arch", ["llama-1b", "llama-100m", "granite-8b",
                                  "qwen2-72b", "minicpm-2b", "chatglm3-6b",
                                  "recurrentgemma-2b", "mamba2-130m",
                                  "internvl2-2b"])
@pytest.mark.parametrize("overrides", [{}, dict(tie_embeddings=False,
                                                qkv_bias=True,
                                                vocab_pad_multiple=128)],
                         ids=["published", "untied_bias_padded"])
def test_param_defs_match_reference(arch, overrides):
    jdefs = j_lm_param_defs(dataclasses.replace(j_get_config(arch),
                                                **overrides))
    tdefs = build_model(dataclasses.replace(get_config(arch), **overrides),
                        device="cpu").defs
    assert sorted(tdefs) == sorted(jdefs)
    for key, d in jdefs.items():
        assert tuple(tdefs[key].shape) == tuple(d.shape), key
        assert tdefs[key].init == d.init, key
        assert tuple(tdefs[key].axes) == tuple(d.axes), key


def test_init_params_keys_and_shapes_match_reference():
    overrides = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=128, vocab_size=300)
    jdefs = j_lm_param_defs(dataclasses.replace(j_get_config("llama-1b"),
                                                **overrides))
    model = build_model(dataclasses.replace(get_config("llama-1b"),
                                            **overrides), device="cpu")
    params = model.init(seed=0)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            out.update(flat(v, path + "/") if isinstance(v, dict)
                       else {path: v})
        return out

    fp = flat(params)
    assert sorted(fp) == sorted(jdefs)
    for key, d in jdefs.items():
        assert tuple(fp[key].shape) == tuple(d.shape), key
        assert fp[key].dtype == torch.bfloat16, key
    assert torch.equal(fp["final_norm_scale"].float(), torch.ones(64))
    # the reference's std: 1/sqrt(leading dim) — for stacked weights that
    # is the layer count
    std = fp["blocks/mlp/w_in"].float().std().item()
    assert abs(std - 2 ** -0.5) < 0.05
