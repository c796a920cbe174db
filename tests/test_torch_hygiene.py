"""Import hygiene of the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` never import ``jax`` or the JAX package ``repro``; the
port imports with JAX unavailable; and its entry points default to CUDA,
raising without a card unless the caller passes ``device="cpu"``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


def _sources() -> list[Path]:
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.prune, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.train, "
            "repro_torch.checkpoint, repro_torch.optim, "
            "repro_torch.convert, repro_torch.kernels.ops; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card and without device="cpu", every entry point raises —
    no silent CPU fallback."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy, tensor_from_numpy
    from repro_torch.core.api import PruneConfig
    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch.prune import prune_arch
    from repro_torch.models.model_builder import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b", reduced=True)
    a = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tensor_from_numpy(a)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": a})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibration_batches(cfg, num_samples=2, seq_len=4, batch=2)
    assert params_from_numpy({"w": a}, device="cpu")["w"].device.type == "cpu"
    assert calibration_batches(cfg, num_samples=2, seq_len=4, batch=2,
                               device="cpu")[0]["tokens"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prune_arch("tinyllama-1.1b", PruneConfig(), log=None)
    monkeypatch.setattr("sys.argv", ["serve"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main()
    assert build_model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The training CLI, ``TrainStream`` and a ``Trainer`` over a default
    model raise without a card unless given device="cpu"."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticCorpus, TrainStream
    from repro_torch.launch import train
    from repro_torch.models.model_builder import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = SyntheticCorpus(vocab_size=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainStream(corpus, global_batch=2, seq_len=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(build_model(get_config("tinyllama-1.1b", reduced=True)),
                AdamW(), constant(1e-3), None, TrainerConfig())
    stream = TrainStream(corpus, global_batch=2, seq_len=4, device="cpu")
    assert stream.batch_at(0)["tokens"].device.type == "cpu"
    trainer = train.main(["--steps", "1", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu", "--batch", "1", "--seq", "8"])
    assert len(trainer.history) == 1
