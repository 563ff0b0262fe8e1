"""Checkpoints in facegen's format (facegen/utils/checkpoint.py).

A checkpoint is a directory ``<dir>/<name>/`` holding ``arrays.npz``
(every leaf of the saved state, keyed by tree path, e.g.
``params_g/03_upconv1/w`` or ``state_g/04_batch_norm/var``) and
``meta.json`` (format version, run config). Saving first moves an
existing checkpoint to ``<name>.old``.

``jax_to_torch`` turns the leaves of G and D into the port's
state_dicts: conv kernels HWIO -> OIHW, dense kernels (in, out) ->
(out, in), leaf names to torch's (w -> weight, a -> weight, scale ->
weight, mean -> running_mean, ...). ``torch_to_jax`` is its inverse. The
port writes the four-leaf bundle (params_g, state_g, params_d, state_d)
that facegen's restore_gan loads strictly.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

FORMAT_VERSION = 1

# checkpoint tree roots of G's and D's leaves; other roots (optimizer
# moments, the gate's ring buffer, counters) are not read here
_ROOTS = {"params_g": "g", "state_g": "g", "params_d": "d", "state_d": "d"}
_NETS = {"g": ("params_g", "state_g"), "d": ("params_d", "state_d")}
_TORCH_NAME = {"w": "weight", "b": "bias", "a": "weight", "scale": "weight",
               "bias": "bias", "mean": "running_mean", "var": "running_var"}


def save(directory: str, name: str, arrays: Dict[str, np.ndarray],
         meta: Optional[dict] = None) -> str:
    """Write ``<directory>/<name>/``; an existing one moves to ``.old``
    first (adversarial.lua:322-324)."""
    os.makedirs(directory, exist_ok=True)
    target = os.path.join(directory, name)
    tmp = target + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"version": FORMAT_VERSION, **(meta or {})}, f, indent=1)
    if os.path.exists(target):
        old = target + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(target, old)
    os.rename(tmp, target)
    return target


def load(directory: str, name: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays keyed by tree path, meta) of ``<directory>/<name>/``."""
    target = os.path.join(directory, name)
    with np.load(os.path.join(target, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(target, "meta.json")) as f:
        meta = json.load(f)
    return arrays, meta


def split_network_arg(network: str, default_dir: str = "logs") -> Tuple[str, str]:
    """'name', 'dir/name' or 'dir/name.net' -> (directory, name); a bare
    name resolves under ``default_dir`` (utils/checkpoint.py:115-126)."""
    directory, name = os.path.split(network.rstrip("/"))
    directory = directory or default_dir
    if name.endswith(".net"):
        name = name[: -len(".net")]
    return directory, name


def load_meta(directory: str, name: str) -> dict:
    """A checkpoint's meta.json; {} when there is none."""
    path = os.path.join(directory, name, "meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def jax_to_torch(arrays: Dict[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Checkpoint leaves -> {"g": state_dict, "d": state_dict}."""
    out = {"g": {}, "d": {}}
    for key, arr in arrays.items():
        net = _ROOTS.get(key.split("/", 1)[0])
        if net is None:
            continue
        _, *path, leaf = key.split("/")
        a = np.asarray(arr)
        if leaf == "w":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[net][".".join(path + [_TORCH_NAME[leaf]])] = torch.from_numpy(np.array(a))
    return out


def torch_to_jax(state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """{"g": state_dict, "d": state_dict} -> checkpoint leaves."""
    arrays = {}
    for net, sd in state_dicts.items():
        params, state = _NETS[net]
        for key, t in sd.items():
            prefix, name = key.rsplit(".", 1)
            a = t.detach().cpu().numpy()
            root = params
            if name in ("running_mean", "running_var"):
                root, leaf = state, name[len("running_"):]
            elif f"{prefix}.running_mean" in sd:  # batch norm
                leaf = "scale" if name == "weight" else "bias"
            elif name == "bias":
                leaf = "b"
            elif a.ndim == 1:  # PReLU slope
                leaf = "a"
            else:
                leaf = "w"
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            arrays["/".join([root, *prefix.split("."), leaf])] = np.ascontiguousarray(a)
    return arrays


def save_gan(directory: str, name: str, g: nn.Module, d: nn.Module, config: dict) -> str:
    """Write G and D as facegen's four-leaf bundle; ``config`` goes to
    meta.json's "config" (scale, grayscale, noise_dim, noise_view), which
    restore_gan in either package reads."""
    arrays = torch_to_jax({"g": g.state_dict(), "d": d.state_dict()})
    return save(directory, name, arrays, meta={"config": config})


def load_gan(directory: str, name: str, g: nn.Module, d: nn.Module) -> dict:
    """Load G's and D's leaves of a checkpoint into ``g`` and ``d``
    (strict: every parameter and buffer must be present, no other G/D
    leaf may be). Returns the checkpoint's meta."""
    arrays, meta = load(directory, name)
    sds = jax_to_torch(arrays)
    g.load_state_dict(sds["g"], strict=True)
    d.load_state_dict(sds["d"], strict=True)
    return meta
