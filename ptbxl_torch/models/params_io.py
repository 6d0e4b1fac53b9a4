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
  Dense kernels (in, out) -> (out, in) (params_io.py:147-261);
  ``arch='backbone'`` keeps the conv blocks and ``proj`` of an ECGCNN.
* ``to_flax_variables`` is its inverse; ``save_npz`` writes the native
  format and ``export_pth`` the reference one, for the trainer's best
  checkpoints (params_io.py:207-350).
"""

from __future__ import annotations

import os
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


ARCHS = ("ecgcnn", "multimodal", "backbone")


def check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")


def from_flax_variables(variables: Dict[str, Any], arch: str = "ecgcnn") -> StateDict:
    """Flax ``{'params', 'batch_stats'}`` numpy tree -> reference state dict.

    ``arch='backbone'`` is the multimodal warm start's source
    (``torch_to_flax_backbone``, params_io.py:223): the conv blocks and, when
    present, ``proj`` of an ECGCNN-or-ECGBackbone tree, without a head.
    """
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
        if arch == "backbone":
            if "proj" in params:
                _dense_to_state(params["proj"], "proj", out)
            return out
        _dense_to_state(params["proj"], "proj", out)
    _dense_to_state(params["head"], "head", out)
    return out


def _np(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().float().numpy()


def _blocks_to_flax(state: StateDict, prefix: str) -> Tuple[Dict, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    i = 0
    while f"{prefix}{i}.net.0.weight" in state:
        b = f"{prefix}{i}.net."
        params[f"blocks_{i}"] = {
            "conv": {"kernel": np.transpose(_np(state[b + "0.weight"]), (2, 1, 0)),
                     "bias": _np(state[b + "0.bias"])},
            "bn": {"scale": _np(state[b + "1.weight"]), "bias": _np(state[b + "1.bias"])},
        }
        stats[f"blocks_{i}"] = {"bn": {"mean": _np(state[b + "1.running_mean"]),
                                       "var": _np(state[b + "1.running_var"])}}
        i += 1
    return params, stats


def _dense_to_flax(state: StateDict, name: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(state[name + ".weight"]).T.copy(), "bias": _np(state[name + ".bias"])}


def to_flax_variables(state: StateDict, arch: str = "ecgcnn") -> Dict[str, Any]:
    """Reference state dict -> flax ``{'params', 'batch_stats'}`` numpy tree, the
    inverse of ``from_flax_variables`` (``torch_to_flax_*``, params_io.py:207-249)
    for ``arch`` 'ecgcnn' or 'multimodal'."""
    if arch not in ("ecgcnn", "multimodal"):
        raise ValueError(f"to_flax_variables: arch 'ecgcnn' or 'multimodal', got {arch!r}")
    if arch == "multimodal":
        bb_params, bb_stats = _blocks_to_flax(state, "ecg_backbone.backbone.")
        bb_params["proj"] = _dense_to_flax(state, "ecg_backbone.proj")
        params = {
            "ecg_backbone": bb_params,
            "demo_encoder": {"fc1": _dense_to_flax(state, "demo_encoder.mlp.0"),
                             "fc2": _dense_to_flax(state, "demo_encoder.mlp.2")},
            "film_gen": _dense_to_flax(state, "film_gen"),
            "head": _dense_to_flax(state, "head"),
        }
        return {"params": params, "batch_stats": {"ecg_backbone": bb_stats}}
    params, stats = _blocks_to_flax(state, "backbone.")
    params["proj"] = _dense_to_flax(state, "proj")
    params["head"] = _dense_to_flax(state, "head")
    return {"params": params, "batch_stats": stats}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_npz(path: str, variables: Dict[str, Any], classes: Optional[List[str]] = None) -> None:
    """The native single-file format (params_io.py:332-341): the variable tree
    flattened with ``/`` plus ``__classes__``; the JAX package's ``load_npz``
    reads it."""
    flat = _flatten(variables)
    if classes is not None:
        flat["__classes__"] = np.array(classes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def export_pth(path: str, state: StateDict, classes: Optional[List[str]] = None) -> None:
    """A reference-compatible ``.pth``: ``{"model_state": state_dict, "classes": [...]}``
    (classes only when given), tensors on the CPU (params_io.py:288-302)."""
    payload: Dict[str, Any] = {
        "model_state": {k: v.detach().cpu().clone() for k, v in state.items()}}
    if classes is not None:
        payload["classes"] = list(classes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str, arch: str = "ecgcnn") -> Tuple[StateDict, Optional[List[str]]]:
    """``.npz`` (native) or ``.pth`` (reference) -> (state_dict, classes).

    ``arch='backbone'`` keeps only the conv blocks and ``proj`` of an ECGCNN
    checkpoint (the multimodal warm start, ``models.factory.merge_backbone``).
    """
    check_arch(arch)
    if path.endswith(".npz"):
        variables, classes = load_npz(path)
        return from_flax_variables(variables, arch), classes
    state, classes = read_pth(path)
    if arch == "backbone":
        state = {k: v for k, v in state.items()
                 if k.startswith("backbone.") or k.startswith("proj.")}
    return state, classes
