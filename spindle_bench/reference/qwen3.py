"""The plain reference of the dense decoder (Qwen3): the whole sequence's
forward in float32 with plain ``torch`` operations, layer by layer, no
kernel, cache or batch.

Per layer: RMSNorm, q / k / v projections, RMSNorm of each q and k head,
rotary embedding over the two halves of each head, causal attention in
which q head ``h`` reads kv head ``h // (H / H_kv)``, the output
projection and the residual; RMSNorm, the SwiGLU and the residual.  A
final RMSNorm and the tied embedding's transpose give the logits.

``quant="fp8"`` is the control: every matrix product takes both its
operands rounded to float8 (e4m3, one scale per tensor), the step below
the bfloat16 the configuration states; in the backward each product of
a gradient takes its operands rounded as well (the gradient to e5m2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the whole tensor."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded to float8 e4m3, and in the
    backward each product's operands rounded too: the incoming gradient
    to float8 e5m2, each with its own per-tensor scale (the usual split
    of float8 training)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _mm(a: torch.Tensor, b: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    if quant == "fp8":
        return _Fp8Product.apply(a, b)
    return a @ b


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1, the two halves rotated."""
    s, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(x: torch.Tensor, lay: Dict, i: int, config: Dict,
          quant: Optional[str] = None) -> torch.Tensor:
    """Layer ``i`` of ``lay`` (the stacked layer tree) on the residual
    stream x (S, d), float32."""
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    h, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    s = x.shape[0]
    w = {k: v[i].float() for k, v in lay["attn"].items()}
    y = _rms(x, lay["attn_norm"]["scale"][i].float(), eps)
    q = _mm(y, w["wq"].reshape(y.shape[-1], -1), quant).view(s, h, hd)
    k = _mm(y, w["wk"].reshape(y.shape[-1], -1), quant).view(s, kv, hd)
    v = _mm(y, w["wv"].reshape(y.shape[-1], -1), quant).view(s, kv, hd)
    q = _rope(_rms(q, w["q_norm"], eps), theta)
    k = _rope(_rms(k, w["k_norm"], eps), theta)
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.einsum("qhd,khd->hqk", q, k) / hd ** 0.5
    att = att.masked_fill(~mask, float("-inf")).softmax(-1)
    o = torch.einsum("hqk,khd->qhd", att, v).reshape(s, h * hd)
    x = x + _mm(o, w["wo"].reshape(h * hd, -1), quant)
    m = {k: v[i].float() for k, v in lay["mlp"].items()}
    y = _rms(x, lay["ffn_norm"]["scale"][i].float(), eps)
    g = _mm(y, m["w_gate"], quant)
    return x + _mm(torch.nn.functional.silu(g) * _mm(y, m["w_up"], quant),
                   m["w_down"], quant)


def _head(params: Dict, config: Dict, x: torch.Tensor,
          quant: Optional[str]) -> torch.Tensor:
    y = _rms(x, params["final_norm"]["scale"].float(),
             config["rms_norm_eps"])
    head = params["lm_head"].float() if "lm_head" in params \
        else params["embed"].float().T
    return _mm(y, head, quant)


def logits(params: Dict, config: Dict, tokens: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """tokens (S,) -> float32 logits (S, V) at every position."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = params["embed"][tokens.long()].float()
    for i in range(config["num_hidden_layers"]):
        x = layer(x, params["layers"], i, config, quant)
    return _head(params, config, x, quant)


def row_loss(params: Dict, config: Dict, tokens: torch.Tensor,
             z_coef: float, quant: Optional[str] = None) -> torch.Tensor:
    """One row's summed next-token loss (cross entropy plus ``z_coef``
    times the squared log-normaliser at every position), each layer
    recomputed in the backward to keep the activations small."""
    from torch.utils.checkpoint import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = params["embed"][tokens.long()].float()
    for i in range(config["num_hidden_layers"]):
        x = checkpoint(layer, x, params["layers"], i, config, quant,
                       use_reentrant=False)
    z = _head(params, config, x[:-1], quant)
    lse = torch.logsumexp(z, -1)
    gold = z.gather(-1, tokens[1:].long()[:, None])[:, 0]
    return (lse - gold + z_coef * lse.square()).sum()


def served_gaps(params: Dict, config: Dict, prompt: torch.Tensor,
                served: torch.Tensor, quant: Optional[str] = None
                ) -> torch.Tensor:
    """Per served token, how far below the reference's best logit at its
    position the token lies.  With ``quant`` set, the same for the token
    that the lower-precision forward puts first at each position.

    The positions are those the serving engine feeds (the JAX package's
    engine does the same): the prompt at 0..P-1, the prompt's last token
    again at P (the first decode step re-feeds it), then each served
    token but the last; served token ``j`` is read at position P + j."""
    seq = torch.cat([prompt, prompt[-1:], served[:-1]])
    at = prompt.numel()
    ref = logits(params, config, seq)[at:]
    pick = served.long() if quant is None else \
        logits(params, config, seq, quant)[at:].argmax(-1)
    return ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
