"""ST-MEM's ViT-B/75 ECG encoder, served by ``Predictor`` (``arch="st_mem"``).

Na, Park, Tae, Joo, *Guiding Masked Representation Learning to Capture
Spatio-Temporal Relationship of Electrocardiogram*, ICLR 2024
(arXiv:2402.09450; https://github.com/bakqui/ST-MEM, ``st_mem_vit_base``),
with a 5-superclass linear head as its PTB-XL fine-tuning uses.  From raw
``[B, T, 12]`` (10 s at 500 Hz, as PTB-XL's ``filename_hr`` records):

* front end: ``ops/signal.py::resample_linear`` 500 -> 250 Hz, the first
  ``samples`` (2250: 9 s), then the per-lead z-score of ``ops/preprocess.py``
  (the two-pass form at ``precision='highest'``, the one-pass form
  otherwise, as ``Predictor`` z-scores the CNNs).  This front end is a
  deployment's, not ST-MEM's published filtering;
* tokens: each lead cut into ``samples // patch`` (30) patches of ``patch``
  (75) samples, embedded by one Linear, plus the position table ``P[1 + j]``;
  each lead's patches between two SEP tokens ``sigma + P[0]`` and
  ``sigma + P[n + 1]``; ``P`` is shared by every lead and every token of lead
  ``l`` adds ``E[l]``.  The sequence is lead-major: ``leads * (n + 2)`` (384)
  tokens;
* ``depth`` pre-LayerNorm blocks: ``h += proj(MHA(LN1(h)))`` with the qkv
  Linear (bias on) and ``F.scaled_dot_product_attention`` over every token,
  no mask; ``h += fc2(GELU(fc1(LN2(h))))`` with the exact (erf) GELU;
* head: the mean over the patch tokens (SEP tokens left out), LayerNorm,
  Linear.

Parameters are f32; ``dtype`` is the compute dtype, as in ``ECGCNN``: at
``torch.bfloat16`` every Linear, the attention, LayerNorm, GELU and the
residual stream take bf16 activations (LayerNorm's statistics in f32, as
torch computes them), while the front end stays f32.
``precision='highest'`` runs the whole forward with TF32 off.  Under a
``torch.profiler`` session a forward records the span ``st_mem.encoder``
(``rows``, ``tokens``) and each block's attention ``st_mem.attention``
(``rows``, ``tokens``, ``heads``; ``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass
from ptbxl_torch.ops.signal import resample_linear
from ptbxl_torch.utils.device import precision_scope
from ptbxl_torch.utils.profiling import span

LN_EPS = 1e-5
HEAD_DIM = 64  # every published ST-MEM encoder: width 768 in 12 heads of 64
FS_IN, FS_MODEL = 500.0, 250.0  # the records' rate (PTB-XL's filename_hr) and the encoder's


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


def _norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(dtype), ln.bias.to(dtype), ln.eps)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, d = a.shape
        q, k, v = _linear(self.qkv, a, dtype).view(b, n, 3, self.heads, d // self.heads).permute(
            2, 0, 3, 1, 4)
        with span("st_mem.attention", rows=b, tokens=b * n, heads=self.heads):
            o = F.scaled_dot_product_attention(q, k, v)  # softmax(q k^T / sqrt(d_head)) v
        return _linear(self.proj, o.transpose(1, 2).reshape(b, n, d), dtype)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, a, dtype)), dtype)


class Block(nn.Module):
    """One pre-LayerNorm transformer block on ``[B, N, width]``."""

    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MLP(width, mlp)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = h + self.attn(_norm(self.norm1, h, dtype), dtype)
        return h + self.mlp(_norm(self.norm2, h, dtype), dtype)


class STMEM(nn.Module):
    """ST-MEM encoder + linear head; input raw ``[B, T, leads]`` at ``FS_IN``."""

    def __init__(
        self,
        num_labels: int = 5,
        width: int = 768,
        depth: int = 12,
        heads: int = 12,
        mlp: int = 3072,
        patch: int = 75,
        samples: int = 2250,
        leads: int = 12,
        precision: Optional[str] = "highest",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if samples % patch:
            raise ValueError(f"samples {samples} is not a multiple of patch {patch}")
        self.patches = samples // patch
        self.samples, self.patch, self.leads = samples, patch, leads
        self.tokens = leads * (self.patches + 2)
        self.patch_embed = nn.Linear(patch, width)
        self.pos_embed = nn.Parameter(torch.empty(self.patches + 2, width))
        self.sep_embed = nn.Parameter(torch.empty(width))
        self.lead_embed = nn.Parameter(torch.empty(leads, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.head = nn.Linear(width, num_labels)
        self.precision = precision
        self.dtype = dtype
        self._zscore = (zscore_per_lead_batch if precision == "highest"
                        else zscore_per_lead_batch_onepass)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Truncated-normal (std 0.02) Linear kernels and embeddings, zero
        biases, LayerNorm at scale 1 and shift 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        for p in (self.pos_embed, self.sep_embed, self.lead_embed):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)

    def embed(self, z: torch.Tensor) -> torch.Tensor:
        """z-scored ``[B, samples, leads]`` -> lead-major tokens ``[B, tokens, width]``."""
        dt, b, n = self.dtype, z.shape[0], self.patches
        p = z.transpose(1, 2).reshape(b, self.leads, n, self.patch).to(dt)
        pos, sep = self.pos_embed.to(dt), self.sep_embed.to(dt)
        e = _linear(self.patch_embed, p, dt) + pos[1:n + 1]
        first = (sep + pos[0]).expand(b, self.leads, 1, -1)
        last = (sep + pos[n + 1]).expand(b, self.leads, 1, -1)
        h = torch.cat([first, e, last], dim=2) + self.lead_embed.to(dt)[:, None]
        return h.reshape(b, self.tokens, -1)

    def pool(self, h: torch.Tensor) -> torch.Tensor:
        """Mean over the patch tokens of ``[B, tokens, width]``, SEP tokens left out."""
        b = h.shape[0]
        return h.view(b, self.leads, self.patches + 2, -1)[:, :, 1:-1].mean(dim=(1, 2))

    def forward(self, x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Raw ``[B, T, leads]`` -> logits ``[B, num_labels]`` in ``dtype``;
        ``normalize=False`` skips the z-score (the records are z-scored already)."""
        rows, dt = x.shape[0], self.dtype
        with span("st_mem.encoder", rows=rows, tokens=rows * self.tokens), \
                precision_scope(self.precision):
            z = resample_linear(x.float(), FS_IN, FS_MODEL)[:, :self.samples]
            h = self.embed(self._zscore(z) if normalize else z)
            for blk in self.blocks:
                h = blk(h, dt)
            return _linear(self.head, _norm(self.norm, self.pool(h), dt), dt)


def widths(state: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """``STMEM``'s sizes from a state dict's shapes; ``heads`` is the width
    over ``HEAD_DIM``."""
    width, patch = state["patch_embed.weight"].shape
    depth = 0
    while f"blocks.{depth}.norm1.weight" in state:
        depth += 1
    return dict(num_labels=state["head.weight"].shape[0], width=width, depth=depth,
                heads=width // HEAD_DIM, mlp=state["blocks.0.mlp.fc1.weight"].shape[0],
                patch=patch, samples=patch * (state["pos_embed"].shape[0] - 2),
                leads=state["lead_embed"].shape[0])
