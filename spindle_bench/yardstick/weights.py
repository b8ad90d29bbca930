"""Random weights of a dense decoder (the Qwen3 layout), made on the
device from the seed in a dozen large calls, in the port's parameter
tree: the benchmark's input, handed to the program and to the
reference alike."""

from __future__ import annotations

from typing import Dict

import torch


def model_config(config: Dict):
    """The port's ``ModelConfig`` for a configuration file: the port's
    registered architecture with every size taken from the file."""
    import dataclasses

    from repro_torch.models import registry

    base = registry.get(config["port_arch"]).cfg
    return dataclasses.replace(
        base, n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"],
        tie_embeddings=config["tie_word_embeddings"],
        rope_theta=config["rope_theta"], norm_eps=config["rms_norm_eps"],
        qkv_bias=config["attention_bias"], qk_norm=True)


def dtype_of(config: Dict) -> torch.dtype:
    """The dtype the configuration states for its weights."""
    return getattr(torch, config["torch_dtype"])


def dense_decoder(config: Dict, seed: int, device) -> Dict:
    """The parameter tree from ``seed`` in the configuration's dtype:
    every matrix N(0, r^2), every norm scale 1 + N(0, r^2), r the
    configuration's initializer range."""
    dtype = dtype_of(config)
    gen = torch.Generator(device=device).manual_seed(
        int(seed) & (2 ** 63 - 1))
    r = config["initializer_range"]
    n, d = config["num_hidden_layers"], config["hidden_size"]
    h, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, f = config["head_dim"], config["intermediate_size"]

    def w(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(r)

    def scale(*shape):
        return w(*shape).add_(1.0)

    tree = {
        "embed": w(config["vocab_size"], d),
        "final_norm": {"scale": scale(d)},
        "layers": {
            "attn_norm": {"scale": scale(n, d)},
            "ffn_norm": {"scale": scale(n, d)},
            "attn": {"wq": w(n, d, h, hd), "wk": w(n, d, kv, hd),
                     "wv": w(n, d, kv, hd), "wo": w(n, h, hd, d),
                     "q_norm": scale(n, hd), "k_norm": scale(n, hd)},
            "mlp": {"w_gate": w(n, d, f), "w_up": w(n, d, f),
                    "w_down": w(n, f, d)},
        },
    }
    if not config["tie_word_embeddings"]:
        tree["lm_head"] = w(d, config["vocab_size"])
    return tree
