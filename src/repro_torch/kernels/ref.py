"""Plain PyTorch versions of the port's kernels.

The CPU path of each wrapper and the yardstick ``chip_smoke.py`` holds
each kernel against on the card. Nothing on the main path calls them
when a card is present.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                        q_chunk: int = 512, k_chunk: int = 1024):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H % KV == 0
    -> (B, Sq, H, hd).

    The function of kernels/csrc/flash_attention.cu, written as
    ``repro.models.attention.flash_attention_ref`` writes it: online
    softmax over k-chunks inside a loop over q-chunks, f32 scores and
    accumulator, masked scores -1e30, padded keys masked by the valid
    length, p rounded to the value type before P.V, and the normaliser
    1/max(l, 1e-30). Query i attends to keys j <= i + q_offset when
    ``causal``. GQA heads are repeated here (the kernel indexes them)."""
    B, sq, H, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if kv != H:
        k = k.repeat_interleave(H // kv, dim=2)
        v = v.repeat_interleave(H // kv, dim=2)
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    pq, pk = (-sq) % q_chunk, (-sk) % k_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for q0 in range(0, sq + pq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].float()
        qpos = q0 + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        for k0 in range(0, sk + pk, k_chunk):
            kj = k[:, k0:k0 + k_chunk]
            vj = v[:, k0:k0 + k_chunk]
            kpos = k0 + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqhd,bchd->bhqc", qi, kj.float()) * scale
            mask = kpos[None, :] < sk                        # kv padding
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqc,bchd->bhqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype).transpose(1, 2))         # (B,cq,H,hd)
    out = torch.cat(outs, dim=1)
    return out[:, :sq] if pq else out
