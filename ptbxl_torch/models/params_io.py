"""Checkpoint I/O: the native ``.npz`` format and reference ``.pth`` files.

The port's own copy of what it needs from ``ptbxl_tpu/models/params_io.py``:

* ``load_npz`` reads the native single-file format: the flax variable tree
  flattened with ``/`` (``params/blocks_0/conv/kernel`` ...) plus an optional
  ``__classes__`` entry (params_io.py:310-350).
* ``read_pth`` reads the reference's ``torch.save`` format, either
  ``{"model_state": state_dict, "classes": [...]}`` or a bare state dict.
* ``from_flax_variables`` turns a ``{'params', 'batch_stats'}`` numpy tree
  into the reference state-dict layout that the port's modules use:
  ``backbone.{i}.net.{0,1}.*``, ``proj.*``, ``head.*`` for ``arch='ecgcnn'``;
  ``ecg_backbone.backbone.{i}.net.{0,1}.*``, ``ecg_backbone.proj.*``,
  ``demo_encoder.mlp.{0,2}.*``, ``film_gen.*``, ``head.*`` for
  ``arch='multimodal'``.  Conv kernels go (k, in, out) -> (out, in, k) and
  Dense kernels (in, out) -> (out, in) (params_io.py:147-261).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_npz(path: str) -> Tuple[Dict[str, Any], Optional[List[str]]]:
    """Native ``.npz`` -> (flax-layout numpy tree, classes or None)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    classes = None
    if "__classes__" in flat:
        classes = [str(c) for c in flat.pop("__classes__")]
    return _unflatten(flat), classes


def read_pth(path: str) -> Tuple[StateDict, Optional[List[str]]]:
    """Reference ``.pth`` (wrapped or bare state dict) -> (state_dict, classes)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state" in obj:
        classes = [str(c) for c in obj["classes"]] if "classes" in obj else None
        return dict(obj["model_state"]), classes
    return dict(obj), None


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))  # a copy: npz arrays are read-only


def _blocks_to_state(params: Dict, stats: Dict, prefix: str, out: StateDict) -> None:
    i = 0
    while f"blocks_{i}" in params:
        b = f"{prefix}{i}.net."
        p, s = params[f"blocks_{i}"], stats[f"blocks_{i}"]
        out[b + "0.weight"] = _t(np.transpose(np.asarray(p["conv"]["kernel"]), (2, 1, 0)))
        out[b + "0.bias"] = _t(p["conv"]["bias"])
        out[b + "1.weight"] = _t(p["bn"]["scale"])
        out[b + "1.bias"] = _t(p["bn"]["bias"])
        out[b + "1.running_mean"] = _t(s["bn"]["mean"])
        out[b + "1.running_var"] = _t(s["bn"]["var"])
        out[b + "1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        i += 1


def _dense_to_state(p: Dict, name: str, out: StateDict) -> None:
    out[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
    out[name + ".bias"] = _t(p["bias"])


ARCHS = ("ecgcnn", "multimodal")


def check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch={arch!r}: the port loads {ARCHS}; the 'backbone' warm start "
            "comes with training, ROADMAP queue 1 item 7"
        )


def from_flax_variables(variables: Dict[str, Any], arch: str = "ecgcnn") -> StateDict:
    """Flax ``{'params', 'batch_stats'}`` numpy tree -> reference state dict."""
    check_arch(arch)
    out: StateDict = {}
    params, stats = variables["params"], variables["batch_stats"]
    if arch == "multimodal":
        bb = params["ecg_backbone"]
        _blocks_to_state(bb, stats["ecg_backbone"], "ecg_backbone.backbone.", out)
        _dense_to_state(bb["proj"], "ecg_backbone.proj", out)
        _dense_to_state(params["demo_encoder"]["fc1"], "demo_encoder.mlp.0", out)
        _dense_to_state(params["demo_encoder"]["fc2"], "demo_encoder.mlp.2", out)
        _dense_to_state(params["film_gen"], "film_gen", out)
    else:
        _blocks_to_state(params, stats, "backbone.", out)
        _dense_to_state(params["proj"], "proj", out)
    _dense_to_state(params["head"], "head", out)
    return out


def load_checkpoint(path: str, arch: str = "ecgcnn") -> Tuple[StateDict, Optional[List[str]]]:
    """``.npz`` (native) or ``.pth`` (reference) -> (state_dict, classes)."""
    check_arch(arch)
    if path.endswith(".npz"):
        variables, classes = load_npz(path)
        return from_flax_variables(variables, arch), classes
    return read_pth(path)
