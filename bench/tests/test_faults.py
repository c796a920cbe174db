"""The check that decides ``correct``, against a timed path broken
underneath: each fault a cell can have is planted in the port (in the
child process only) and the run, at a tiny size on the CPU, must come out
not correct.  The look for a card is skipped; the rest of a run is the
harness's own."""
import pytest

from tiny import run_cell

SELECT_SHIFTED = """
orig = mod.ServingEngine._select
def bad(self, logits):
    return (orig(self, logits) + 1) % logits.shape[-1]
mod.ServingEngine._select = bad
"""
STEP_KEEPS_STATE = """
import copy
def bad(model, params, cache, tokens, pos):
    scratch = {k: copy.deepcopy(v) for k, v in cache.items()}
    logits, _ = model.decode_step(params, scratch, tokens, pos)
    return logits[:, -1, :]
mod._decode_fn = bad
"""
HALF_THE_BATCH = """
orig = mod._decode_fn
def bad(model, params, cache, tokens, pos):
    out = orig(model, params, cache, tokens, pos)
    h = out.shape[0] // 2
    return torch.cat([out[:h], out[:out.shape[0] - h]])
mod._decode_fn = bad
"""
PRUNE_KEEPS_STATE = """
orig = mod.prune_layer_guarded
def bad(w, h, cfg, **kw):
    res, guard = orig(w, h, cfg, **kw)
    return res._replace(weights=w.clone()), guard
mod.prune_layer_guarded = bad
"""
HALF_THE_CALIBRATION = """
orig = mod._capture
def bad(adapter, params, i, carries, accs, keep=None, faults=None):
    return orig(adapter, params, i, carries[:max(1, len(carries) // 2)],
                accs, keep, faults)
mod._capture = bad
"""
ROW_ALTERED = """
orig = mod.prune_layer_guarded
def bad(w, h, cfg, **kw):
    res, guard = orig(w, h, cfg, **kw)
    out = res.weights.clone()
    out[0] = -out[0]
    return res._replace(weights=out), guard
mod.prune_layer_guarded = bad
"""

FAULTS = [
    ("qwen3moe-gen", "repro_torch.serve.engine", SELECT_SHIFTED),
    ("qwen3moe-gen", "repro_torch.serve.engine", STEP_KEEPS_STATE),
    ("qwen3moe-gen", "repro_torch.serve.engine", HALF_THE_BATCH),
    ("mistral-prune", "repro_torch.core.schedule", PRUNE_KEEPS_STATE),
    ("mistral-prune", "repro_torch.core.schedule", HALF_THE_CALIBRATION),
    ("mistral-prune", "repro_torch.core.schedule", ROW_ALTERED),
]
IDS = ["token-altered", "step-keeps-state", "half-the-batch",
       "solve-keeps-state", "half-the-calibration", "answer-altered"]


@pytest.mark.parametrize("cell,target,patch", FAULTS, ids=IDS)
def test_a_broken_path_is_not_correct(cell, target, patch):
    res = run_cell(cell, patches=[(target, "fault", patch)])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["qwen3moe-gen", "mistral-prune"])
def test_the_sound_path_is_correct(cell):
    assert run_cell(cell)["correct"] is True
