"""Attention layers and the two-way (token <-> image) transformer.

Counterpart of the JAX package's ``modeling/transformer.py``: batch-first
[B, N, C] tokens, fp32 softmax, optional RoPE from cos/sin tables in the
halves layout (q/k projection columns permuted by ``rope_channel_perm``),
a count of trailing key tokens left unrotated (the object pointers), the
late-v_proj value path and the bank-indirect (banked) cross-attention.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, LayerNorm, sdpa
from .position_encoding import (
    apply_rope_halves,
    rope_channel_perm,
)


def _permuted(lin: nn.Linear, x: torch.Tensor,
              perm: Optional[torch.Tensor], with_bias: bool = True):
    """lin(x) with its output columns permuted (perm indexes weight rows)."""
    w, b = lin.weight, lin.bias if with_bias else None
    if perm is not None:
        w = w.index_select(0, perm)
        b = None if b is None else b.index_select(0, perm)
    return F.linear(x.to(w.dtype), w, b)


class Attention(nn.Module):
    """Multi-head attention with internal downsampling, a separate kv input
    width, RoPE and an additive key bias."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1, kv_in_dim: Optional[int] = None,
                 attention_fn: Callable = sdpa,
                 banked_attention_fn: Optional[Callable] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.kv_in_dim = kv_in_dim
        kv = kv_in_dim if kv_in_dim is not None else embedding_dim
        self.q_proj = nn.Linear(embedding_dim, self.internal)
        self.k_proj = nn.Linear(kv, self.internal)
        self.v_proj = nn.Linear(kv, self.internal)
        self.out_proj = nn.Linear(self.internal, embedding_dim)
        self.attention_fn = attention_fn
        self.banked_attention_fn = banked_attention_fn
        self._perm = {}

    def perm(self, device) -> torch.Tensor:
        """Per-head rope_channel_perm of the projection columns."""
        p = self._perm.get(device)
        if p is None:
            dh = self.internal // self.num_heads
            p = torch.as_tensor(
                (np.arange(self.num_heads)[:, None] * dh
                 + rope_channel_perm(dh)[None, :]).reshape(-1),
                device=device,
            )
            self._perm[device] = p
        return p

    def project_k(self, x: torch.Tensor) -> torch.Tensor:
        """Bank-write-time K cache: k_proj (with bias) of x in the permuted
        column layout; the caller rotates (or not, for pointer tokens)."""
        return _permuted(self.k_proj, x, self.perm(x.device))

    def forward_banked(self, q: torch.Tensor, rope_q, banked: dict):
        """Bank-indirect cross-attention: K/V are read from the bank rows by
        K2; only the query side and the per-tile K correction
        w = Wk @ tpos (rope distributes over the sum) are computed here."""
        assert self.num_heads == 1, "banked memory attention is single-head"
        perm = self.perm(q.device)
        qp = _permuted(self.q_proj, q, perm)[:, None]  # [B, 1, Nq, D]
        qp = apply_rope_halves(qp, *rope_q)
        w = _permuted(self.k_proj, banked["tpos_vecs"], perm, with_bias=False)
        o = self.banked_attention_fn(
            qp, banked["mem_k"], banked["mem_v"], banked["slots"], w.float(),
            banked["bias"], banked["cos"], banked["sin"], banked["layer"],
        )[:, 0]  # [B, Nq, Cm]
        o = self.v_proj(o)
        # objects with no live key have P = 0: strip the bias v_proj added
        live = (banked["bias"] > -1e29).any(-1)[:, None, None]  # [B, 1, 1]
        o = torch.where(live, o, o - self.v_proj.bias)
        return self.out_proj(o)

    def forward(self, q, k, v, rope_q: Optional[Tuple] = None,
                rope_k: Optional[Tuple] = None,
                num_k_rope: Optional[int] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.num_heads
        b, nq = q.shape[0], q.shape[1]
        nk = k.shape[1]
        # late v_proj: attention runs against the RAW narrow values and
        # v_proj applies after, P @ (M Wv + bv) = (P @ M) Wv + bv since rows
        # of P sum to one (Dv = kv_in_dim < D in memory cross-attention)
        kv_in = v.shape[-1]
        late_v = self.kv_in_dim is not None and kv_in < self.internal and h == 1
        roped = rope_q is not None or rope_k is not None
        perm = self.perm(q.device) if roped else None
        q = _permuted(self.q_proj, q, perm)
        k = _permuted(self.k_proj, k, perm)
        if not late_v:
            v = self.v_proj(v.to(self.v_proj.weight.dtype))
        else:
            v = v.to(self.v_proj.weight.dtype)
        q = q.reshape(b, nq, h, -1).transpose(1, 2)
        k = k.reshape(b, nk, h, -1).transpose(1, 2)
        v = v.reshape(b, nk, h, -1).transpose(1, 2)
        if rope_q is not None:
            q = apply_rope_halves(q, *rope_q)
        if rope_k is not None:
            nkr = nk if num_k_rope is None else num_k_rope
            if nkr == nk:
                k = apply_rope_halves(k, *rope_k)
            else:
                k = torch.cat(
                    [apply_rope_halves(k[:, :, :nkr], *rope_k), k[:, :, nkr:]],
                    dim=2,
                )
        o = self.attention_fn(q, k, v, bias=bias)
        o = o.transpose(1, 2).reshape(b, nq, -1)
        if late_v:
            o = self.v_proj(o)
            if bias is not None:
                # rows with no live key have P = 0: remove v_proj's bias
                live = (bias > -1e29).flatten(1).any(-1)[:, None, None]
                o = torch.where(live, o, o - self.v_proj.bias)
        return self.out_proj(o)


class TwoWayAttentionBlock(nn.Module):
    """Token self-attn, token->image cross-attn, token MLP, image->token
    cross-attn."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        d = embedding_dim
        self.self_attn = Attention(d, num_heads)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.cross_attn_token_to_image = Attention(
            d, num_heads, downsample_rate=attention_downsample_rate)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.mlp = MLP(d, mlp_dim, d, 2, activation=F.relu)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.norm4 = LayerNorm(d, eps=1e-5)
        self.cross_attn_image_to_token = Attention(
            d, num_heads, downsample_rate=attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Bidirectional decoder transformer."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth)
        )
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, downsample_rate=attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe [B, N_img, C]; point_embedding
        [B, N_tok, C] -> (queries, keys)."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys
