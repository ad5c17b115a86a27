"""Memory attention: conditions current-frame tokens on the memory bank.

Counterpart of the JAX package's ``modeling/memory_attention.py``: SAM 2.1's
4-layer RoPE self + cross transformer over a fixed-capacity memory layout
whose invalid tokens carry an additive -1e30 bias. Three modes:

  * ``attend``: memory tokens given densely (gather mode; K1 with a bias);
  * ``attend_banked``: K/V read from the bank rows by K2;
  * ``project_k``: the per-layer cached cross-attention keys written to the
    bank with a memory.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .configs import MemoryAttentionConfig
from .layers import LayerNorm, sdpa
from .position_encoding import (
    apply_rope_halves,
    axial_rope_cos_sin,
)
from .transformer import Attention


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig, attention_fn: Callable,
                 banked_attention_fn: Optional[Callable]):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.self_attn = Attention(c.d_model, c.num_heads,
                                   attention_fn=attention_fn)
        self.cross_attn_image = Attention(
            c.d_model, c.num_heads, kv_in_dim=c.kv_in_dim,
            attention_fn=attention_fn, banked_attention_fn=banked_attention_fn,
        )
        self.norm1 = LayerNorm(c.d_model, eps=1e-5)
        self.norm2 = LayerNorm(c.d_model, eps=1e-5)
        self.norm3 = LayerNorm(c.d_model, eps=1e-5)
        self.linear1 = nn.Linear(c.d_model, c.dim_feedforward)
        self.linear2 = nn.Linear(c.dim_feedforward, c.d_model)

    def forward(self, tgt, memory, pos, query_pos, rope_q, rope_k=None,
                num_k_rope: int = 0, memory_bias=None, banked=None):
        c = self.cfg
        # self-attention (pos_enc_at_attn=False in SAM 2.1: no pos added)
        tgt2 = self.norm1(tgt)
        qk = tgt2 + query_pos if c.pos_enc_at_attn else tgt2
        tgt = tgt + self.self_attn(qk, qk, tgt2, rope_q=rope_q, rope_k=rope_q)
        # cross-attention against memory (+pos on keys, not queries)
        tgt2 = self.norm2(tgt)
        q = tgt2 + query_pos if c.pos_enc_at_cross_attn_queries else tgt2
        if banked is not None:
            tgt2 = self.cross_attn_image.forward_banked(q, rope_q, banked)
        else:
            k = memory + pos if c.pos_enc_at_cross_attn_keys else memory
            tgt2 = self.cross_attn_image(
                q, k, memory, rope_q=rope_q, rope_k=rope_k,
                num_k_rope=num_k_rope, bias=memory_bias,
            )
        tgt = tgt + tgt2
        # feed-forward
        tgt2 = self.linear1(self.norm3(tgt))
        tgt2 = F.relu(tgt2) if c.activation == "relu" else F.gelu(tgt2)
        return tgt + self.linear2(tgt2)


class MemoryAttention(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig, attention_fn: Callable = sdpa,
                 banked_attention_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(cfg, attention_fn, banked_attention_fn)
            for _ in range(cfg.num_layers)
        )
        self.norm = LayerNorm(cfg.d_model, eps=1e-5)
        self._rope = {}

    def rope(self, device):
        """Axial RoPE cos/sin [S, D/2] fp32 on `device` (built once)."""
        t = self._rope.get(device)
        if t is None:
            c = self.cfg
            ex, ey = c.rope_feat_sizes
            cos, sin = axial_rope_cos_sin(c.d_model // c.num_heads, ex, ey,
                                          c.rope_theta)
            t = (torch.as_tensor(cos, device=device),
                 torch.as_tensor(sin, device=device))
            self._rope[device] = t
        return t

    def project_k(self, x: torch.Tensor, roped: bool = True) -> torch.Tensor:
        """x [B, S, mem_dim] = memory (+ spatial pos) of one tile -> each
        layer's cached cross-attention K [B, L, S, D], rotated unless
        roped=False (obj-ptr staging tokens)."""
        ex, ey = self.cfg.rope_feat_sizes
        assert (not roped) or x.shape[1] == ex * ey
        cos, sin = self.rope(x.device)
        ks = []
        for layer in self.layers:
            k = layer.cross_attn_image.project_k(x)
            if roped:
                k = apply_rope_halves(k, cos, sin)
            ks.append(k)
        return torch.stack(ks, dim=1)

    def forward(self, curr, memory=None, curr_pos=None, memory_pos=None,
                num_obj_ptr_tokens: int = 0, num_mem_frames: int = 0,
                memory_mask: Optional[torch.Tensor] = None,
                banked: Optional[dict] = None) -> torch.Tensor:
        """curr [B, Nq, C] current-frame tokens. Gather mode: memory
        [B, Nk, mem_dim] = num_mem_frames * Nq spatial tokens then the
        obj-ptr tokens, memory_mask [B, Nk] True = valid. Banked mode
        (banked given): mem_k / mem_v / slots / tpos_vecs of the bank and
        memory_mask [B, T*S]."""
        c = self.cfg
        nq = curr.shape[1]
        ex, ey = c.rope_feat_sizes
        assert nq == ex * ey, f"query tokens {nq} != rope grid {ex}x{ey}"
        rope_q = self.rope(curr.device)
        output = curr
        if c.pos_enc_at_input and curr_pos is not None:
            output = output + 0.1 * curr_pos

        if banked is not None:
            bias = torch.where(memory_mask, 0.0, -1e30).float()  # [B, T*S]
            for i, layer in enumerate(self.layers):
                output = layer(
                    output, None, None, curr_pos, rope_q,
                    banked=dict(banked, bias=bias, layer=i,
                                cos=rope_q[0], sin=rope_q[1]),
                )
            return self.norm(output)

        num_k_rope = memory.shape[1] - num_obj_ptr_tokens
        assert num_k_rope == num_mem_frames * nq, (
            "memory layout must be num_mem_frames*Nq spatial tokens followed "
            f"by obj-ptr tokens; got Nk={memory.shape[1]}, "
            f"frames={num_mem_frames}, ptr={num_obj_ptr_tokens}"
        )
        reps = max(num_mem_frames, 1)
        rope_k = (rope_q[0].repeat(reps, 1), rope_q[1].repeat(reps, 1))
        bias = None
        if memory_mask is not None:
            bias = torch.where(memory_mask, 0.0, -1e30).float()[:, None, None, :]
        for layer in self.layers:
            output = layer(
                output, memory, memory_pos, curr_pos, rope_q, rope_k=rope_k,
                num_k_rope=num_k_rope, memory_bias=bias,
            )
        return self.norm(output)
