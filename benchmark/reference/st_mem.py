"""The plain reference of the ``st_mem`` configuration, in float32 PyTorch.

ST-MEM's ViT-B/75 encoder (Na, Park, Tae, Joo, ICLR 2024, arXiv:2402.09450;
https://github.com/bakqui/ST-MEM, ``st_mem_vit_base``) with a linear head,
written from the configuration file (``benchmark/configs/st_mem.json``):

1. front end: raw ``x [B, T, 12]`` at ``sample_rate_hz`` resampled linearly
   to ``model_sample_rate_hz`` (``T * fs_out / fs_in`` output positions
   spread evenly over ``[0, T - 1]``), the first ``model_samples`` kept, and
   the per-lead z-score ``(c - mean) / (std + zscore_eps)`` with the
   population std over them;
2. tokens: ``e[l, j] = W_pe z[patch j : patch (j + 1), l] + b_pe + P[1 + j]``;
   SEP tokens ``sigma + P[0]`` and ``sigma + P[n + 1]`` around each lead's
   ``n`` patches; ``E[l]`` added to every token of lead ``l``; lead-major;
3. ``depth`` pre-LayerNorm blocks: ``h += W_o attn(LN1 h) + b_o`` with
   ``q, k, v`` from one ``W_qkv`` (with bias), ``softmax(q k^T / sqrt(d)) v``
   a head over every token, no mask; ``h += W_2 GELU(W_1 LN2 h + b_1) + b_2``;
4. head: the mean over the patch tokens (SEP tokens left out), ``LN_f``,
   ``W_h``; probabilities by the sigmoid.

Departures from the published description, and what could not be checked
here: the front end is a deployment's (PTB-XL's 10 s 500 Hz records brought to
ST-MEM's 9 s at 250 Hz), not ST-MEM's own filtering; the output positions
are the float32 values of ``linspace(0, T - 1, n)`` as the system's JAX
package computes them, ``i * ((T - 1) * (1 / (n - 1)))`` rounded in f32 at each
step with the last exactly ``T - 1`` (a position one ulp away moves a
weight by up to 2.4e-4 at T = 5000); recalled from ST-MEM's encoder module and
not checked against it: the learned position table shared by every lead, the
qkv bias, the exact (erf) GELU, pre-LayerNorm blocks, LayerNorm eps 1e-5 and
the final LayerNorm.  The key names are the port's (the published checkpoint
is not in the repository; the benchmark draws the weights from ``--seed``).

It takes a state dict of plain tensors and nothing that the program made.
``precision`` is as in ``reference/ecg.py``: ``"f32"`` (TF32 off, the
reference itself), or a control: ``"tf32"`` (TF32 allowed) or ``"fp8"``
(every matmul operand, the attention's q, k, v and probabilities included,
rounded to float8 e4m3 with a per-tensor scale, products summed in f32;
below the bfloat16 that the cell runs).
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ecg import arithmetic, fp8


def patches(cfg: Mapping) -> int:
    return cfg["model_samples"] // cfg["patch"]


def param_shapes(cfg: Mapping) -> List[Tuple[str, List[int]]]:
    """Every leaf's key and shape, in the configuration's order."""
    d, m, n = cfg["width"], cfg["mlp"], patches(cfg)
    out = [("patch_embed.weight", [d, cfg["patch"]]), ("patch_embed.bias", [d]),
           ("pos_embed", [n + 2, d]), ("sep_embed", [d]), ("lead_embed", [cfg["leads"], d])]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", [d]), (b + "norm1.bias", [d]),
                (b + "attn.qkv.weight", [3 * d, d]), (b + "attn.qkv.bias", [3 * d]),
                (b + "attn.proj.weight", [d, d]), (b + "attn.proj.bias", [d]),
                (b + "norm2.weight", [d]), (b + "norm2.bias", [d]),
                (b + "mlp.fc1.weight", [m, d]), (b + "mlp.fc1.bias", [m]),
                (b + "mlp.fc2.weight", [d, m]), (b + "mlp.fc2.bias", [d])]
    return out + [("norm.weight", [d]), ("norm.bias", [d]),
                  ("head.weight", [cfg["num_labels"], d]), ("head.bias", [cfg["num_labels"]])]


def resample(x: torch.Tensor, fs_in: float, fs_out: float) -> torch.Tensor:
    """Linear resampling of ``[B, T, C]`` along T at the positions above."""
    t = x.shape[1]
    n = int(round(t * fs_out / fs_in))
    step = np.float32(t - 1) * (np.float32(1) / np.float32(n - 1))
    pos = torch.arange(n, dtype=torch.float32, device=x.device) * float(step)
    pos[-1] = t - 1
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=t - 1)
    w = (pos - lo)[None, :, None]
    return x[:, lo] * (1 - w) + x[:, hi] * w


def front(x: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    """Raw ``[B, T, 12]`` -> z-scored ``[B, model_samples, 12]``."""
    r = resample(x.float(), cfg["sample_rate_hz"], cfg["model_sample_rate_hz"])
    r = r[:, :cfg["model_samples"]]
    mean = r.mean(dim=1, keepdim=True)
    std = (r - mean).square().mean(dim=1, keepdim=True).sqrt()
    return (r - mean) / (std + cfg["zscore_eps"])


def _ops(precision: str, *ts):
    return [fp8(t) for t in ts] if precision == "fp8" else list(ts)


def _linear(p, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return F.linear(*_ops(precision, x, p[name + ".weight"]), p[name + ".bias"])


def _norm(p, name: str, x: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], cfg["ln_eps"])


def tokens(p: Mapping[str, torch.Tensor], cfg: Mapping, z: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """z-scored ``[B, S, L]`` -> lead-major tokens ``[B, L * (n + 2), width]``."""
    b, leads, n, pt = z.shape[0], cfg["leads"], patches(cfg), cfg["patch"]
    seg = z.transpose(1, 2).reshape(b, leads, n, pt)
    pos, sep = p["pos_embed"], p["sep_embed"]
    e = _linear(p, "patch_embed", seg, precision) + pos[1:n + 1]
    first = (sep + pos[0]).expand(b, leads, 1, -1)
    last = (sep + pos[n + 1]).expand(b, leads, 1, -1)
    h = torch.cat([first, e, last], dim=2) + p["lead_embed"][:, None]
    return h.reshape(b, leads * (n + 2), -1)


def attention(p, name: str, a: torch.Tensor, cfg: Mapping, precision: str) -> torch.Tensor:
    b, n, d = a.shape
    hd = d // cfg["heads"]
    q, k, v = _linear(p, name + ".qkv", a, precision).view(b, n, 3, cfg["heads"], hd).unbind(2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, hd]
    q, k = _ops(precision, q, k)
    s = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    s, v = _ops(precision, s, v)
    o = (s @ v).transpose(1, 2).reshape(b, n, d)
    return _linear(p, name + ".proj", o, precision)


def logits(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Raw ``[B, T, 12]`` -> logits ``[B, num_labels]``."""
    h = tokens(p, cfg, front(x, cfg), precision)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        h = h + attention(p, b + ".attn", _norm(p, b + ".norm1", h, cfg), cfg, precision)
        a = F.gelu(_linear(p, b + ".mlp.fc1", _norm(p, b + ".norm2", h, cfg), precision))
        h = h + _linear(p, b + ".mlp.fc2", a, precision)
    n = patches(cfg)
    feat = h.view(h.shape[0], cfg["leads"], n + 2, -1)[:, :, 1:n + 1].mean(dim=(1, 2))
    return _linear(p, "head", _norm(p, "norm", feat, cfg), precision)


@torch.no_grad()
def probs(p: Mapping[str, torch.Tensor], cfg: Mapping, x, block_rows: int = 256,
          precision: str = "f32", device=None) -> torch.Tensor:
    """Probabilities of host or device rows, in blocks of ``block_rows``."""
    device = device or next(iter(p.values())).device
    out = []
    with arithmetic(precision):
        for i in range(0, len(x), block_rows):
            xb = torch.as_tensor(x[i:i + block_rows], device=device)
            out.append(torch.sigmoid(logits(p, cfg, xb, precision)).cpu())
    return torch.cat(out)
