"""Operation and byte counts of the dense decoder, from its sizes alone:
what the algorithm needs, each input byte read once and each output
byte written once, whatever a kernel reads again."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def matmul_params(config: Dict) -> int:
    """Weights that take part in a matrix product per token: the
    projections, the SwiGLU and the output head (the embedding lookup
    is no product)."""
    d, f = config["hidden_size"], config["intermediate_size"]
    h, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    layer = d * hd * (2 * h + 2 * kv) + 3 * d * f
    return config["num_hidden_layers"] * layer + d * config["vocab_size"]


def attention_flops(config: Dict, keys: int) -> int:
    """One query position's attention over ``keys`` keys, every layer:
    the score and the value products."""
    return 4 * config["num_hidden_layers"] * config["num_attention_heads"] \
        * config["head_dim"] * keys


def decoder_tokens(config: Dict, prompt: int, out: int) -> float:
    """FLOPs of serving one request through one-position steps: every
    prompt position and every output token but the last is a step whose
    logits are computed, position ``p`` attending to ``p + 1`` keys."""
    n = prompt + out - 1
    keys = n * (n + 1) // 2
    return 2.0 * matmul_params(config) * n + attention_flops(config, keys)


def flash_decode(config: Dict, prompt: int, out: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the flash-decode calls of one request's steps,
    its valid row only: at each step and layer the row's keys and values
    up to its length (bfloat16), its query read and its output
    written."""
    n = prompt + out - 1
    keys = n * (n + 1) // 2
    layers = config["num_hidden_layers"]
    h, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    nbytes = layers * 2 * (2 * kv * hd * keys + 2 * h * hd * n)
    return float(nbytes), float(attention_flops(config, keys))


def train_step(config: Dict, batch: int, seq: int) -> float:
    """FLOPs of one training step: forward and backward of the products
    (6 a weight a token) and of the causal attention (three times its
    forward's half square)."""
    tokens = batch * seq
    causal_keys = seq * (seq + 1) // 2
    return 6.0 * matmul_params(config) * tokens + \
        3.0 * batch * attention_flops(config, causal_keys)


def flash_attention(config: Dict, batch: int, seq: int, backward: bool
                    ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one layer's causal flash attention in bfloat16:
    the forward reads q, k, v and writes o (two products over the causal
    half); the backward also reads o and do and writes dq, dk, dv (four
    products)."""
    h, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    causal = seq * (seq + 1) // 2
    q = batch * seq * h * hd * 2
    k = batch * seq * kv * hd * 2
    fwd_bytes = 2 * q + 2 * k
    fwd_flops = 4 * batch * h * hd * causal
    if not backward:
        return float(fwd_bytes), float(fwd_flops)
    return float(4 * q + 4 * k), float(2 * fwd_flops)


def roofline_seconds(nbytes: float, flops: float, flops_per_s: float
                     ) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the peak."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / flops_per_s)
