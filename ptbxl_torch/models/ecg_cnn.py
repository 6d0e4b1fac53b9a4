"""1D-CNN ECG classifier (PyTorch port of ``ptbxl_tpu/models/ecg_cnn.py``).

4 x (Conv1d k=15 SAME -> BatchNorm -> ReLU -> MaxPool(2)), channels
12->32->64->128->256, mean over time, 256-d projection, linear head; 719,397
parameters for 5 labels.  Submodule names follow the reference state dict
(``backbone.{i}.net.{0,1}.*``, ``proj.*``, ``head.*``), so a reference
``.pth`` loads with plain ``load_state_dict``.

* Public methods take and return channels-last ``[B, T, C]`` like the JAX
  models; the modules transpose to ``[B, C, T]`` inside for ``nn.Conv1d``.
* ``features``/``tail`` split at the last conv's pre-activation
  (ecg_cnn.py:211-237): Grad-CAM differentiates ``tail`` with autograd.
* MaxPool(2) floors odd lengths (T=5000 -> 2500 -> 1250 -> 625 -> 312);
  ReLU -> MaxPool(2) differentiates through K6 (``ops/relu_pool.py``).
* ``model.train()`` is JAX's ``train=True``: BatchNorm normalizes with the
  batch statistics and updates the running ones as flax does (biased
  variance, ``ConvBlock._train_batch_norm``).  Under a data-parallel mesh
  (``parallel/mesh.py::shard_model`` sets ``ConvBlock.sync_group``) the
  statistics are the global batch's, as GSPMD makes them in JAX.
* ``precision='highest'`` runs f32 convs and matmuls with TF32 off;
  ``dtype=torch.bfloat16`` computes in bf16 from the f32 parameters (the
  JAX ``dtype`` attribute).
* ``torch_init=True`` is torch's own default init (the reference's
  distribution); ``False`` is flax's default (lecun-normal kernels, zero
  biases), as in the JAX package.  Both draw from an explicit generator.
* ``phase_train=True`` runs a train-mode block whose input length is even
  in the phase domain (``ops/phase_conv.py``; JAX ``ConvBlock.__call__``,
  ecg_cnn.py:166-170): the same function, whose pool backward is the
  phase max's instead of K6.  Off by default, as in JAX; eval mode and the
  last block (which ``features``/``tail`` split) never take it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ptbxl_torch.ops.phase_conv import phase_conv_cf
from ptbxl_torch.ops.relu_pool import relu_max_pool2
from ptbxl_torch.parallel.collectives import ColumnParallelLinear, all_reduce_sum
from ptbxl_torch.utils.device import precision_scope

PARITY_PRECISION = "highest"
BN_EPS = 1e-5


def _init_weight(w: torch.Tensor, fan_in: int, torch_init: bool,
                 generator: Optional[torch.Generator]) -> None:
    if torch_init:  # kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        bound = fan_in ** -0.5
        nn.init.uniform_(w, -bound, bound, generator=generator)
    else:  # flax lecun_normal: truncated normal on [-2, 2] std, rescaled
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _init_bias(b: torch.Tensor, fan_in: int, torch_init: bool,
               generator: Optional[torch.Generator]) -> None:
    if torch_init:
        bound = fan_in ** -0.5
        nn.init.uniform_(b, -bound, bound, generator=generator)
    else:
        nn.init.zeros_(b)


@torch.no_grad()
def reset_layers(blocks: Sequence[nn.Module], linears: Sequence[nn.Linear], torch_init: bool,
                 generator: Optional[torch.Generator]) -> None:
    """Initialise conv blocks (BN to scale 1, bias 0, mean 0, var 1) and Linear layers."""
    for blk in blocks:
        conv, bn = blk.net[0], blk.net[1]
        fan_in = conv.in_channels * conv.kernel_size[0]
        _init_weight(conv.weight, fan_in, torch_init, generator)
        _init_bias(conv.bias, fan_in, torch_init, generator)
        bn.reset_parameters()
    for lin in linears:
        _init_weight(lin.weight, lin.in_features, torch_init, generator)
        _init_bias(lin.bias, lin.in_features, torch_init, generator)


def dense(lin: nn.Linear, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Linear layer computed in ``dtype`` from its f32 parameters (flax ``dtype``):
    the product is rounded to ``dtype``, then the bias is added, as flax does.
    A column-parallel layer computes its columns and gathers the rest."""
    sharded = isinstance(lin, ColumnParallelLinear)
    if sharded:
        v = lin.copy_in(v)
    y = F.linear(v.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)
    return lin.gather(y) if sharded else y


class ConvBlock(nn.Module):
    """Conv1d(k=15, SAME) -> BatchNorm -> ReLU -> MaxPool(2) on ``[B, C, T]``.

    ``conv_only``/``post`` expose the pre-BN conv activation, the Grad-CAM tap.
    ``sync_group``: the data group whose global batch train-mode BatchNorm
    normalizes with (None: this rank's batch).  ``phase_train``: the
    train-mode forward of an even-length input in the phase domain.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 15,
                 pool: int = 2, dtype: torch.dtype = torch.float32, phase_train: bool = False):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv1d(in_features, features, kernel_size, padding=kernel_size // 2),
            nn.BatchNorm1d(features, eps=BN_EPS, momentum=0.1),
            nn.ReLU(),
            nn.MaxPool1d(pool),
        )
        self.pool = pool
        self.dtype = dtype
        self.phase_train = phase_train
        self.sync_group = None

    def conv_only(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.net[0]
        dt = self.dtype
        y = F.conv1d(x.to(dt), conv.weight.to(dt), padding=conv.padding)
        return y + conv.bias.to(dt)[:, None]  # the bias after the rounded product, as flax

    def _train_batch_norm(self, a: torch.Tensor) -> torch.Tensor:
        """flax's train-mode BatchNorm: normalize with the batch statistics over
        (B, T) in f32 and round once to ``a``'s dtype (one fused batch-norm
        launch forward and one backward); the running stats move by
        ``momentum`` towards the batch mean and the *biased* variance, as flax
        updates them (torch's own running update stores the unbiased one).
        The variance is torch's two-pass one where flax takes
        ``max(0, E[a^2] - E[a]^2)``: the rounding differs, within the JAX
        parity tests' tolerances (tests/test_torch_train_step.py)."""
        bn = self.net[1]
        if self.sync_group is not None:
            return self._synced_batch_norm(a)
        with torch.no_grad():
            var, mean = torch.var_mean(a.float(), dim=(0, 2), correction=0)
            self._update_running(mean, var)
        return F.batch_norm(a, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        bn = self.net[1]
        m = bn.momentum
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var + m * var)

    def _synced_batch_norm(self, a: torch.Tensor) -> torch.Tensor:
        """Train-mode BatchNorm over the data group's global (B, T): the f32
        count and sums, then the centred sums, each summed over the group by
        a differentiable all-reduce (whose backward sums too); the biased
        variance; the running stats moved as above, the same on every rank.
        Padded rows count as they do unsharded."""
        bn = self.net[1]
        af = a.float()
        count = af.new_full((1,), float(af.shape[0] * af.shape[2]))
        sums = all_reduce_sum(torch.cat([af.sum(dim=(0, 2)), count]), self.sync_group)
        n = sums[-1]
        mean = sums[:-1] / n
        d = af - mean[:, None]
        var = all_reduce_sum((d * d).sum(dim=(0, 2)), self.sync_group) / n
        self._update_running(mean.detach(), var.detach())
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        return (d * scale[:, None] + bn.bias[:, None]).to(a.dtype)

    def post(self, a: torch.Tensor) -> torch.Tensor:
        bn = self.net[1]
        if self.training:
            h = self._train_batch_norm(a)
        else:
            # f32 statistics and affine on a dtype input: computed in f32 and
            # rounded once to dtype, as flax normalizes (no f32 copy of the activation)
            h = F.batch_norm(a, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, bn.momentum, bn.eps)
        # relu(pool(h)) == pool(relu(h)) (monotone); pool first as in JAX; the
        # backward is K6 (ops/relu_pool.py)
        if self.pool == 2:
            return relu_max_pool2(h)
        return F.relu(F.max_pool1d(h, self.pool))

    def _phase_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The phase path: the phase conv in ``dtype`` (the bias after the
        rounded product), train-mode BatchNorm over (B, phase, U) through
        ``_train_batch_norm`` (the ``[B, 2C, U]`` output viewed as ``[2B, C, U]``
        holds exactly the elements of ``[B, C, T]``, so the statistics, the
        running update and the data group's sync are the standard path's),
        ReLU, then the max over the phase axis, whose backward splits a tie
        evenly as ``jnp.max``'s does (``torch.max(dim)`` would route it to one)."""
        conv = self.net[0]
        dt = self.dtype
        a = phase_conv_cf(x.to(dt), conv.weight.to(dt), conv.bias.to(dt))
        bsz, c2, u = a.shape
        h = self._train_batch_norm(a.view(2 * bsz, c2 // 2, u))
        return torch.relu(h).view(bsz, 2, c2 // 2, u).amax(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.phase_train and self.pool == 2 and x.shape[2] % 2 == 0:
            return self._phase_forward(x)
        return self.post(self.conv_only(x))


class ECGCNN(nn.Module):
    """CNN encoder + classifier for 12-lead ECG; input ``[B, T, in_leads]``."""

    def __init__(
        self,
        feat_dim: int = 256,
        num_labels: int = 3,
        channels: Sequence[int] = (32, 64, 128, 256),
        in_leads: int = 12,
        precision: Optional[str] = PARITY_PRECISION,
        dtype: torch.dtype = torch.float32,
        torch_init: bool = False,
        generator: Optional[torch.Generator] = None,
        phase_train: bool = False,
    ):
        super().__init__()
        cins = [in_leads] + list(channels[:-1])
        self.backbone = nn.Sequential(
            *[ConvBlock(cin, c, dtype=dtype, phase_train=phase_train)
              for cin, c in zip(cins, channels)]
        )
        self.proj = nn.Linear(channels[-1], feat_dim)
        self.head = nn.Linear(feat_dim, num_labels)
        self.precision = precision
        self.dtype = dtype
        self.reset_parameters(torch_init, generator)

    def reset_parameters(self, torch_init: bool = False,
                         generator: Optional[torch.Generator] = None) -> None:
        reset_layers(self.backbone, (self.proj, self.head), torch_init, generator)

    def _scope(self):
        return precision_scope(self.precision)

    def _dense(self, lin: nn.Linear, v: torch.Tensor) -> torch.Tensor:
        return dense(lin, v, self.dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Blocks 0..n-2 + the last block's conv: ``[B, T, C]`` -> ``[B, T', C_last]``.

        T' = 625 for T = 5000: the last Conv1d pre-activation, the tap the
        reference's Grad-CAM hook captured.
        """
        with self._scope():
            h = x.transpose(1, 2)
            for blk in self.backbone[:-1]:
                h = blk(h)
            return self.backbone[-1].conv_only(h).transpose(1, 2)

    def tail(self, a: torch.Tensor, return_features: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Last block's BN/ReLU/pool + mean over T + proj + head, from ``A``."""
        with self._scope():
            h = self.backbone[-1].post(a.transpose(1, 2))
            g = h.mean(dim=2)
            z = self._dense(self.proj, g)
            logits = self._dense(self.head, z)
        if return_features:
            return logits, z
        return logits

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: [B, T, in_leads] -> logits [B, num_labels] (or (logits, z))."""
        return self.tail(self.features(x), return_features)
