"""MultimodalNet, the FS+ICA transformer classifier: the counterpart of the
JAX package's ``models/transformer.py``.

A sample is one packed vector ``[fs_input_size + windows·C·W]`` (the
data pipeline packs both modalities, ``data/multimodal.py``), unpacked by
static offsets: the FreeSurfer volumes become one token, each ICA window
``[C, W]`` one token, behind a learned CLS token; learned positional
embeddings; pre-LN blocks (attention, then an MLP, each added to an f32
residual stream); the CLS state feeds the head.

What differs from PyTorch's defaults, kept as flax does it: LayerNorm's ε
is 1e-6 and its variance ``E[x²] - E[x]²``; GELU is the tanh
approximation; attention is two products and a softmax whose logits
accumulate and run in f32 whatever the compute dtype, the output back at
v's dtype (:func:`dot_product_attention`). JAX computes all of it outside
any Pallas kernel; so does the port (plain ``torch`` products).

Parameters keep JAX's names and, for the dense layers, ``nn.Linear``'s
layout (``[out, in]``, the transpose of the flax kernel); ``cls`` ``[1, 1,
E]`` and ``pos_embed`` ``[1, T, E]`` keep JAX's shapes (T = 2 + windows).
Ring attention over a mesh's model axis is not ported (ROADMAP A11 (c)).
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.nn import functional as F

from ..weights import LeafTable
from .layers import (
    LayerNorm,
    compute_dtype_of,
    dense,
    param_at,
    site_dropout,
    site_layer_norm,
    site_linear,
)


def dot_product_attention(q, k, v):
    """``[..., T, N, Hd]`` q, k, v → ``[..., T, N, Hd]``: softmax attention
    whose logits accumulate in f32 (a bf16 q and k are exact in f32, so
    their products are) and whose softmax runs in f32; the weights are cast
    to v's dtype for the second product."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.movedim(-2, -3) for t in (q, k, v))  # [..., N, T, Hd]
    logits = (qh.float() @ kh.float().mT) * scale
    weights = torch.softmax(logits, -1).to(v.dtype)
    return (weights @ vh).movedim(-3, -2)


class MultiHeadAttention(nn.Module):
    """``qkv`` (one product to q, k and v) and ``proj``, both biased; the
    heads split ``qkv``'s output in :meth:`MultimodalNet._run`."""

    def __init__(self, embed_dim: int, generator=None):
        super().__init__()
        self.qkv = dense(embed_dim, 3 * embed_dim, generator)
        self.proj = dense(embed_dim, embed_dim, generator)


class TransformerBlock(nn.Module):
    """Pre-LN: ``x + attn(ln1(x))``, then ``x + mlp2(gelu(mlp1(ln2(x))))``."""

    def __init__(self, embed_dim: int, mlp_ratio: int = 4, generator=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.attn = MultiHeadAttention(embed_dim, generator)
        self.ln2 = LayerNorm(embed_dim)
        self.mlp1 = dense(embed_dim, embed_dim * mlp_ratio, generator)
        self.mlp2 = dense(embed_dim * mlp_ratio, embed_dim, generator)


class MultimodalNet(nn.Module):
    """``forward(x [B, fs_input_size + num_windows·num_comps·window_size],
    train, mask, generator)`` returns logits ``[B, num_cls]``; ``mask`` is
    taken for the one signature (no layer mixes rows); ``generator`` draws
    a training forward's dropout masks. ``num_windows`` fixes the token
    count, which JAX reads off its first input. ``compute_dtype=
    "bfloat16"`` runs every product but the head's in bf16, with the
    softmax, LayerNorms and the residual stream in f32. The constructor
    draws the weights from ``generator``: the dense layers torch's uniform,
    ``cls`` and ``pos_embed`` normal(0.02)."""

    @staticmethod
    def leaf_table(num_layers: int = 4) -> LeafTable:
        """The leaves: the two embeddings, ``cls``, ``pos_embed``, each
        block's two LayerNorms and four dense layers, ``ln_f`` and the
        head."""
        def lin(n):
            return [(f"{n}.weight", f"{n}/kernel", True), (f"{n}.bias", f"{n}/bias", False)]

        def ln(n):
            return [(f"{n}.weight", f"{n}/scale", False), (f"{n}.bias", f"{n}/bias", False)]

        names = lin("fs_embed") + lin("ica_embed") + [("cls", "cls", False),
                                                      ("pos_embed", "pos_embed", False)]
        for i in range(num_layers):
            b = f"block_{i}"
            names += (ln(f"{b}.ln1") + lin(f"{b}.attn.qkv") + lin(f"{b}.attn.proj")
                      + ln(f"{b}.ln2") + lin(f"{b}.mlp1") + lin(f"{b}.mlp2"))
        names += ln("ln_f") + lin("head")
        return LeafTable("MultimodalNet", tuple(
            (n, j.replace(".", "/"), tr) for n, j, tr in names))

    @staticmethod
    def leaf_table_of(paths) -> LeafTable | None:
        """The table of a tree whose leaf paths (tuples of keys, JAX's or
        the port's) are MultimodalNet's, else None."""
        tops = {p[0] for p in paths}
        if not {"cls", "pos_embed", "head"} <= tops:
            return None
        return MultimodalNet.leaf_table(sum(re.fullmatch(r"block_\d+", t) is not None
                                            for t in tops))

    def __init__(self, fs_input_size: int = 66, num_comps: int = 100, window_size: int = 10,
                 num_windows: int = 98, embed_dim: int = 256, num_heads: int = 8,
                 num_layers: int = 4, mlp_ratio: int = 4, num_cls: int = 2,
                 dropout_rate: float = 0.1, attention: str = "local", compute_dtype=None,
                 generator=None):
        super().__init__()
        if attention == "ring":
            raise NotImplementedError("MultimodalNet(attention='ring') shards the tokens over "
                                      "a mesh's model axis, which is not ported: ROADMAP A11 "
                                      "(c)")
        if attention != "local":
            raise ValueError(f"attention must be 'local' or 'ring', got {attention!r}")
        self.fs_input_size, self.num_windows = fs_input_size, num_windows
        self.token_size = num_comps * window_size
        self.embed_dim, self.num_heads, self.num_layers = embed_dim, num_heads, num_layers
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        g = generator
        self.fs_embed = dense(fs_input_size, embed_dim, g)
        self.ica_embed = dense(self.token_size, embed_dim, g)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_windows + 2, embed_dim))
        with torch.no_grad():
            for p in (self.cls, self.pos_embed):
                p.normal_(0.0, 0.02, generator=g)
        for i in range(num_layers):
            setattr(self, f"block_{i}", TransformerBlock(embed_dim, mlp_ratio, g))
        self.ln_f = LayerNorm(embed_dim)
        self.head = dense(embed_dim, num_cls, g)
        self._names = [n for n, _, _ in self.leaf_table(num_layers).params]

    def _dropout(self, h, train: bool, generator):
        if not train or self.dropout_rate == 0.0:
            return h
        return site_dropout(h, self.dropout_rate, generator)

    def _run(self, p, x, train: bool, generator):
        S, B = x.shape[:2]
        E, N, T = self.embed_dim, self.num_heads, self.num_windows + 2
        cdt = compute_dtype_of(self.compute_dtype)
        fs = x[..., :self.fs_input_size]
        ica = x[..., self.fs_input_size:].reshape(S, B * self.num_windows, self.token_size)
        fs_tok = site_linear(p["fs_embed.weight"], p["fs_embed.bias"], fs, cdt).float()
        ica_tok = site_linear(p["ica_embed.weight"], p["ica_embed.bias"], ica, cdt).float()
        h = torch.cat([p["cls"].expand(S, B, 1, E), fs_tok[:, :, None],
                       ica_tok.reshape(S, B, self.num_windows, E)], 2) + p["pos_embed"]
        for i in range(self.num_layers):
            b = f"block_{i}."
            a = site_layer_norm(h, p[b + "ln1.weight"], p[b + "ln1.bias"])
            qkv = site_linear(p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"],
                              a.reshape(S, B * T, E), cdt)
            q, k, v = qkv.reshape(S, B, T, 3, N, E // N).unbind(3)
            a = site_linear(p[b + "attn.proj.weight"], p[b + "attn.proj.bias"],
                            dot_product_attention(q, k, v).reshape(S, B * T, E), cdt)
            h = h + self._dropout(a.float().reshape(S, B, T, E), train, generator)
            m = site_layer_norm(h, p[b + "ln2.weight"], p[b + "ln2.bias"])
            m = F.gelu(site_linear(p[b + "mlp1.weight"], p[b + "mlp1.bias"],
                                   m.reshape(S, B * T, E), cdt), approximate="tanh")
            m = site_linear(p[b + "mlp2.weight"], p[b + "mlp2.bias"], m, cdt)
            h = h + self._dropout(m.float().reshape(S, B, T, E), train, generator)
        h = site_layer_norm(h, p["ln_f.weight"], p["ln_f.bias"])
        return site_linear(p["head.weight"], p["head.bias"], h[:, :, 0])

    def forward(self, x, train: bool = True, mask=None, generator=None):
        params = {n: param_at(self, n)[None] for n in self._names}
        return self._run(params, x[None], train, generator)[0]

    def site_forward(self, params, x, mask, stats, generator=None, train: bool = True):
        """The forward of every site at once: ``params`` by ``state_dict``
        name as site-batched views ``[S, ...]``, ``x [S, B, packed]``,
        ``mask [S, B]`` (no layer mixes rows: the loss weights padding),
        ``stats`` empty, ``generator`` for the dropout masks, which
        ``train=False`` (the eval of personalized heads) turns off.
        Returns ``(logits [S, B, num_cls], {})``."""
        return self._run(params, x, train, generator), {}
