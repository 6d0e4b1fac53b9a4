"""ECGFounder's Net1D, served by ``Predictor`` (``arch="ecgfounder"``).

Li et al., *An Electrocardiogram Foundation Model Built on over 10 Million
Recordings with External Evaluation across Multiple Domains* (NEJM AI 2025,
arXiv:2410.04133; https://github.com/PKUDigitalHealth/ECGFounder, model
``Net1D`` of ``net1d.py``), at the widths its fine-tuning builds:
``base_filters=64, ratio=1, filter_list=[64, 160, 160, 400, 400, 1024,
1024], m_blocks_list=[2, 2, 2, 3, 3, 4, 4], kernel_size=16, stride=2,
groups_width=16, use_bn=False, use_do=False`` and 150 labels (30,752,646
parameters).  From z-scored ``[B, T, leads]`` (``Predictor`` z-scores the
records as it does for the CNNs):

* SAME conv (kernel ``k``, stride ``s``, length ``T``): ``T_out = ceil(T / s)``,
  ``p = max(0, (T_out - 1) s + k - T)`` zeros, ``p // 2`` on the left and the
  rest on the right (``same_pads``): 7 | 8 at k=16, stride 1;
* stem: SAME conv ``leads -> base_filters``, k, stride 2, then Swish
  (``x sigmoid(x)``, ``F.silu``);
* stages of ``filter_list[i]`` channels and ``m_blocks_list[i]`` blocks, the
  first block of each at ``stride``.  A block (pre-activation bottleneck, its
  middle width ``C`` since ``ratio`` is 1): Swish (except in the very first
  block), the 1x1 conv ``conv1`` ``C_in -> C``, Swish, the SAME k conv
  ``conv2`` at the block's stride in ``C / groups_width`` groups, Swish, the
  1x1 conv ``conv3``; then the squeeze-and-excitation gate
  ``g = sigmoid(se_fc2(Swish(se_fc1(mean_T(out)))))`` (``C -> C/2 -> C``),
  ``out * g``; plus the shortcut: the block's input, through a max-pool of
  ``stride`` after SAME zero padding (0 | 1 at stride 2, so on an odd length
  the last window is ``max(x, 0)``; ``pool_same``) in a strided block, and
  with ``(C - C_in) // 2`` zero channels before it and the rest after where
  ``C_in != C``;
* head: the mean over time, then the Linear ``filter_list[-1] -> num_labels``.

Activations stay channels-last ``[B, T, C]`` throughout: a 1x1 conv is
``F.linear`` over the channels (one GEMM), the k-wide convs are
``F.conv2d`` on the ``[B, C, 1, T]`` view of the same memory (cuDNN's NHWC
path, no transposes; on the H100 at B=512 in bf16 19.2 ms a chunk against
38.6 ms for ``F.conv1d`` on ``[B, C, T]``), padded by cuDNN where its
symmetric padding and a slice give SAME's, the gate's mean and the head's
are over dimension 1, and the gate's scale and the residual add are one
``addcmul`` (17.5 ms a chunk with both, against 19.2).
Parameters are f32 under ``nn.Conv1d`` / ``nn.Linear`` shapes; ``dtype`` is
the compute dtype, as in ``ECGCNN``: at ``torch.bfloat16`` every conv,
Linear, Swish, the gate and the residual stream take bf16 activations.
``precision='highest'`` runs the whole forward in f32 with TF32 off.  The key
names are the port's own (``stem``, ``stages.{i}.blocks.{j}.conv1``, ...,
``head``), not the released checkpoint's.  Under a ``torch.profiler``
session a forward records ``ecgfounder.encoder`` (``rows``, ``samples``) and
inside it one ``ecgfounder.stage`` a stage (``rows``, ``channels``, ``length``:
the stage's output length, ``blocks``; ``utils/profiling.py``).

With ``graphed`` set (``Predictor`` sets it on one GPU), a forward without
autograd on a GPU replays its pieces (the stem, each stage, the head) as CUDA
graphs captured at the first call of each input shape, one memory pool a
shape: the same kernels on the same memory, launched 9 times a chunk in place
of ~370 times, so the host's launches stop setting the pace (on the H100 at
B=512 in bf16 a chunk is ~16 ms of device work against ~370 launches that a
busy host stretched to ~19-25 ms).  Each stage's replay runs inside its
``ecgfounder.stage`` span.  The graphs read the parameters where they were
at the capture: after moving them, set ``graphed`` again, which drops them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ptbxl_torch.utils.device import precision_scope
from ptbxl_torch.utils.profiling import span

STEM_STRIDE = 2  # Net1D's first conv, whatever ``stride`` the stages take
SE_REDUCTION = 2  # the gate's hidden width is C / 2


def same_pads(length: int, kernel: int, stride: int) -> Tuple[int, int, int]:
    """(T_out, left, right) of a SAME conv or pool on ``length`` samples."""
    out = -(-length // stride)
    p = max(0, (out - 1) * stride + kernel - length)
    return out, p // 2, p - p // 2


def conv_same(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """SAME conv of channels-last ``x [B, T, C_in]`` -> ``[B, T_out, C_out]`` in ``dtype``."""
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    k, s = conv.kernel_size[0], conv.stride[0]
    if k == 1 and s == 1 and conv.groups == 1:
        return F.linear(x, w[:, :, 0], b)
    out, left, right = same_pads(x.shape[1], k, s)
    # cuDNN pads both ends alike: ``pad`` zeros a side, then the outputs from
    # ``skip`` on are SAME's (7 | 8 at stride 1 is 8 | 8 less the first
    # output); where SAME's windows fall between its outputs (7 | 8 at
    # stride 2, an odd length) the zeros are padded here
    pad = max(left, right)
    skip, off = divmod(pad - left, s)
    if off:
        x, pad, skip = F.pad(x, (0, 0, left, right)), 0, 0
    if dtype != torch.float32 and x.device.type == "cpu":
        # oneDNN's bf16 conv on the CPU (torch 2.13) returns wrong sums when
        # grouped or padded: the same rounded operands, summed in f32, rounded once
        x, w, b = x.float(), w.float(), b.float()
    # [B, T, C] memory is NHWC of [B, C, 1, T]: cuDNN's channels-last path
    y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w.unsqueeze(2), b, stride=(1, s),
                 padding=(0, pad), groups=conv.groups)
    return y.squeeze(2).transpose(1, 2)[:, skip:skip + out].to(dtype)


def pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Net1D's padded max-pool over ``[B, T, C]``: ``stride - 1`` zeros,
    ``(stride - 1) // 2`` of them on the left, then a max over windows of
    ``stride`` (the last partial window dropped)."""
    p = stride - 1
    xp = F.pad(x, (0, 0, p // 2, p - p // 2))
    n = xp.shape[1] // stride
    return xp[:, :n * stride].unflatten(1, (n, stride)).amax(dim=2)


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class Block(nn.Module):
    """One pre-activation bottleneck block with its gate and shortcut."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int, stride: int,
                 groups_width: int, first: bool):
        super().__init__()
        if channels % groups_width:
            raise ValueError(f"channels {channels} is not a multiple of groups_width "
                             f"{groups_width}")
        self.in_channels, self.channels, self.stride, self.first = (
            in_channels, channels, stride, first)
        self.conv1 = nn.Conv1d(in_channels, channels, 1)
        self.conv2 = nn.Conv1d(channels, channels, kernel_size, stride,
                               groups=channels // groups_width)
        self.conv3 = nn.Conv1d(channels, channels, 1)
        self.se_fc1 = nn.Linear(channels, channels // SE_REDUCTION)
        self.se_fc2 = nn.Linear(channels // SE_REDUCTION, channels)

    def gate(self, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The squeeze-and-excitation gate ``[B, C]`` of ``out [B, T, C]``."""
        se = F.silu(_linear(self.se_fc1, out.mean(dim=1), dtype))
        return torch.sigmoid(_linear(self.se_fc2, se, dtype))

    def shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = pool_same(x, self.stride)
        extra = self.channels - self.in_channels
        return F.pad(x, (extra // 2, extra - extra // 2)) if extra else x

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = conv_same(self.conv1, x if self.first else F.silu(x), dtype)
        out = conv_same(self.conv2, F.silu(out), dtype)
        out = conv_same(self.conv3, F.silu(out), dtype)
        return torch.addcmul(self.shortcut(x), out, self.gate(out, dtype)[:, None])


class Stage(nn.Module):
    """``blocks`` blocks of ``channels``, the first at the stage's stride."""

    def __init__(self, in_channels: int, channels: int, blocks: int, kernel_size: int,
                 stride: int, groups_width: int, first: bool):
        super().__init__()
        self.channels = channels
        self.blocks = nn.ModuleList(
            Block(in_channels if j == 0 else channels, channels, kernel_size,
                  stride if j == 0 else 1, groups_width, first and j == 0)
            for j in range(blocks))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, dtype)
        return x


class Net1D(nn.Module):
    """Net1D (``use_bn=False``, ``use_do=False``, ``ratio=1``) on z-scored
    ``[B, T, in_channels]``."""

    def __init__(
        self,
        num_labels: int = 150,
        in_channels: int = 12,
        base_filters: int = 64,
        filter_list: Sequence[int] = (64, 160, 160, 400, 400, 1024, 1024),
        m_blocks_list: Sequence[int] = (2, 2, 2, 3, 3, 4, 4),
        kernel_size: int = 16,
        stride: int = 2,
        groups_width: int = 16,
        precision: Optional[str] = "highest",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(filter_list) != len(m_blocks_list):
            raise ValueError(f"{len(filter_list)} stage widths but {len(m_blocks_list)} "
                             "block counts")
        self.stem = nn.Conv1d(in_channels, base_filters, kernel_size, STEM_STRIDE)
        cins = [base_filters] + list(filter_list[:-1])
        self.stages = nn.ModuleList(
            Stage(cin, c, m, kernel_size, stride, groups_width, i == 0)
            for i, (cin, c, m) in enumerate(zip(cins, filter_list, m_blocks_list)))
        self.head = nn.Linear(filter_list[-1], num_labels)
        self.precision = precision
        self.dtype = dtype
        self._graphs: Dict[tuple, _Graphs] = {}
        self.graphed = False
        self.reset_parameters(generator)

    @property
    def graphed(self) -> bool:
        return self._graphed

    @graphed.setter
    def graphed(self, on: bool) -> None:
        self._graphed = on
        self._graphs.clear()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun-normal kernels (truncated at two std, as flax draws them) and zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)

    def steps(self, rows: int, length: int
              ) -> List[Tuple[Optional[Dict[str, int]], Callable[[torch.Tensor], torch.Tensor]]]:
        """The forward on ``[rows, length, in_channels]`` in pieces: the stem,
        each stage, the head, each with its ``ecgfounder.stage`` span's counts
        (``None`` for the stem and the head)."""
        dt = self.dtype
        out = [(None, lambda x: F.silu(conv_same(self.stem, x.to(dt), dt)))]
        length = -(-length // STEM_STRIDE)
        for stage in self.stages:
            length = -(-length // stage.blocks[0].stride)
            out.append((dict(rows=rows, channels=stage.channels, length=length,
                             blocks=len(stage.blocks)),
                        lambda h, stage=stage: stage(h, dt)))
        out.append((None, lambda h: _linear(self.head, h.mean(dim=1), dt)))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """z-scored ``[B, T, in_channels]`` -> logits ``[B, num_labels]`` in ``dtype``."""
        rows, length = x.shape[:2]
        with span("ecgfounder.encoder", rows=rows, samples=rows * length), \
                precision_scope(self.precision):
            steps = self.steps(rows, length)
            if self._graphed and x.is_cuda and not torch.is_grad_enabled():
                key = (tuple(x.shape), x.device)
                graphs = self._graphs.get(key)
                if graphs is None:
                    graphs = self._graphs[key] = _Graphs(steps, x, self.dtype)
                return graphs.replay(x, [counts for counts, _ in steps])
            h = x
            for counts, fn in steps:
                with _stage_span(counts):
                    h = fn(h)
            return h


def _stage_span(counts: Optional[Dict[str, int]]):
    return span("ecgfounder.stage", **counts) if counts else contextlib.nullcontext()


class _Graphs:
    """``Net1D``'s steps captured as CUDA graphs for one input shape, in one
    memory pool: a static input in the compute dtype (the stem's cast is its
    copy) and the head's static logits.  Capture inside the forward's
    precision scope, the steps warmed up first on a side stream."""

    def __init__(self, steps, x: torch.Tensor, dtype: torch.dtype):
        self.input = torch.empty(x.shape, dtype=dtype, device=x.device)
        self.input.copy_(x)
        cur, side = torch.cuda.current_stream(x.device), torch.cuda.Stream(x.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):  # cuDNN's and cuBLAS's plans, off the capture
            h = self.input
            for _, fn in steps:
                h = fn(h)
        cur.wait_stream(side)
        self.graphs, pool, h = [], None, self.input
        for _, fn in steps:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
                h = fn(h)
            pool = g.pool()
            self.graphs.append(g)
        self.output = h

    def replay(self, x: torch.Tensor, counts: List[Optional[Dict[str, int]]]) -> torch.Tensor:
        """The logits of ``x``; a fresh copy (the next replay overwrites the static ones)."""
        self.input.copy_(x)
        for c, g in zip(counts, self.graphs):
            with _stage_span(c):
                g.replay()
        return self.output.clone()


def widths(state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """``Net1D``'s sizes from a state dict's shapes (the stages' stride is no
    shape, so it keeps Net1D's 2)."""
    filters, blocks = [], []
    while f"stages.{len(filters)}.blocks.0.conv3.weight" in state:
        s, m = len(filters), 0
        while f"stages.{s}.blocks.{m}.conv3.weight" in state:
            m += 1
        filters.append(state[f"stages.{s}.blocks.0.conv3.weight"].shape[0])
        blocks.append(m)
    stem = state["stem.weight"]
    return dict(num_labels=state["head.weight"].shape[0], in_channels=stem.shape[1],
                base_filters=stem.shape[0], filter_list=filters, m_blocks_list=blocks,
                kernel_size=stem.shape[2],
                groups_width=state["stages.0.blocks.0.conv2.weight"].shape[1])
