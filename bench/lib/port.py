"""What the harness builds of the program: its model configuration from a
configuration file, and the served tree of a decoder-only transformer
masked 2:4 by magnitude and packed by the port's ``compress_params``."""
from __future__ import annotations

from bench.lib import weights as W


def model_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file: the registry's
    architecture with every field the file's ``model`` gives."""
    from repro_torch.configs.registry import get_config

    return get_config(conf["arch"]).replace(**conf["model"])


def served_params(torch, cfg, seed: int, device) -> dict:
    """Weights drawn from the seed, every prunable kernel masked 2:4 by
    magnitude and packed, block by block so that one block's dense copy is
    alive at a time."""
    from repro_torch.serve.compressed import compress_params

    dt = cfg.torch_dtype
    params = W.head_weights(torch, cfg, seed, device, dt)
    params["blocks"] = {}
    for i in range(cfg.num_layers):
        params["blocks"][i] = W.block_weights(torch, cfg, i, seed, device, dt)
        masks = {}
        for (node, leaf) in W.masked_paths(cfg, i):
            path = ("blocks", i, *node, leaf)
            w = params["blocks"][i][node[0]][node[1]][leaf]
            mask = W.nm_prune_mask(torch, w).to(dt)
            if w.dim() == 3:
                masks.update({path + (e,): mask[e] for e in range(w.shape[0])})
            else:
                masks[path] = mask
        params = compress_params(params, masks, 2, 4, strict=True)
        del masks
    return params
