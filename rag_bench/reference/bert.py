"""The plain reference: a BERT sentence encoder in float32, and its control.

Follows the conventions ``pathway_tpu_torch/models/encoder.py`` documents
for its Flax parity (its lines 1-20), written here from that description:
embeddings (token + position + row 0 of the type table) and a LayerNorm
with epsilon 1e-6; per block, post-norm attention and an exact-erf GELU
MLP; the query divided by sqrt(head size); masked mean pooling and an L2
normalisation with a 1e-9 floor. Everything is float32 with TF32 off
(``fp32_matmuls``). It imports nothing of the program.

``Fp8Matmul`` is the control's arithmetic: the step below the
configuration's bfloat16, each matrix product's two operands rounded to
float8 e4m3 with one scale per tensor, the product summed in float32.

The parameters are the benchmark's own state dict (``rag_bench/weights.py``),
keyed as the port's ``TransformerEncoder`` loads it; the reference reads
them by those names.
"""

from __future__ import annotations

import contextlib

import torch

LN_EPS = 1e-6
_E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for the products inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32."""
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to float8 e4m3 (per-tensor scale)."""
    return torch.matmul(_fp8(a), _fp8(b))


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * w + b


def _dense(x, p, name, mm):
    return mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def encode(params: dict, heads: int, ids: torch.Tensor, lengths: torch.Tensor,
           mm=exact) -> torch.Tensor:
    """Unit sentence embeddings [n, hidden] of token ids [n, L] whose
    first ``lengths`` positions are real; ``mm`` computes each product."""
    p = {k: v.float() for k, v in params.items()}
    n, L = ids.shape
    pos = torch.arange(L, device=ids.device)
    real = pos[None, :] < lengths[:, None]  # [n, L]
    x = p["tok_embed.weight"][ids] + p["pos_embed.weight"][:L][None] \
        + p["type_embed.weight"][0]
    x = _ln(x, p["ln_embed.weight"], p["ln_embed.bias"])
    h = x.shape[-1]
    hd = h // heads
    keep = real[:, None, None, :]
    i = 0
    while f"blocks.{i}.attention.query.weight" in p:
        b = f"blocks.{i}"
        q = _dense(x, p, f"{b}.attention.query", mm).view(n, L, heads, hd).transpose(1, 2)
        k = _dense(x, p, f"{b}.attention.key", mm).view(n, L, heads, hd).transpose(1, 2)
        v = _dense(x, p, f"{b}.attention.value", mm).view(n, L, heads, hd).transpose(1, 2)
        s = mm(q / hd ** 0.5, k.transpose(-1, -2))
        s = torch.where(keep, s, torch.finfo(torch.float32).min)
        w = torch.softmax(s, dim=-1)
        o = mm(w, v).transpose(1, 2).reshape(n, L, h)
        x = _ln(x + _dense(o, p, f"{b}.attention.out", mm),
                p[f"{b}.ln_attn.weight"], p[f"{b}.ln_attn.bias"])
        f = torch.nn.functional.gelu(_dense(x, p, f"{b}.mlp_in", mm), approximate="none")
        x = _ln(x + _dense(f, p, f"{b}.mlp_out", mm),
                p[f"{b}.ln_mlp.weight"], p[f"{b}.ln_mlp.bias"])
        i += 1
    m = real[:, :, None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def encode_texts(params: dict, heads: int, tokenizer, texts, device,
                 mm=exact, block: int = 64) -> torch.Tensor:
    """``encode`` over texts in blocks of ``block`` (padded to each
    block's longest), float32 with TF32 off; returns [n, hidden]."""
    out = []
    with torch.no_grad(), fp32_matmuls():
        for s in range(0, len(texts), block):
            ids, lengths = tokenizer(texts[s:s + block])
            out.append(encode(params, heads, torch.from_numpy(ids).to(device),
                              torch.from_numpy(lengths).to(device), mm))
    return torch.cat(out)
