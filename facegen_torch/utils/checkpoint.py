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

``save_train_state`` / ``load_train_state`` write and read a whole
training state under facegen's leaf paths: the bundle, optax's optimizer
leaves (``opt_g/0/count``, ``opt_g/0/mu/<param path>``,
``opt_g/0/nu/...``; ``sum_of_squares`` for Adagrad, ``trace`` for SGD
with momentum), the counters the state has and ``epoch``. A GAN state
(train/step.py:GanState, facegen's GanState) has ``accs``, ``accs_n``,
``confusion``, ``trained_d`` and ``not_trained_d``; a c2f state
(train/c2f.py:C2FState, facegen's C2FState) has ``confusion`` alone,
and its nets' leaves sit under ``head``/``body`` (``params_g/body/00_conv1/w``).
A facegen trainer checkpoint of either kind resumes in the port and the
reverse.
"""

from __future__ import annotations

import dataclasses
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


def config_meta(cfg) -> dict:
    """A run config as meta.json's "config" (tuples as lists), like
    facegen's config_meta and the reference's ``opt = OPT`` field."""
    return {"config": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(cfg).items()}}


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


def _torch_leaf(path: str, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    """A leaf path below its root ('03_upconv1/w') and its array -> the
    state_dict key ('03_upconv1.weight') and the tensor in torch's layout."""
    *parts, leaf = path.split("/")
    a = np.asarray(arr)
    if leaf == "w":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return ".".join(parts + [_TORCH_NAME[leaf]]), torch.from_numpy(np.array(a))


def _jax_leaf(key: str, t: torch.Tensor, bn_prefixes) -> Tuple[bool, str, np.ndarray]:
    """A state_dict key and tensor -> (whether the leaf is state, not a
    parameter; its path below the root; the array in facegen's layout).
    ``bn_prefixes`` are the module paths of the batch norms, whose weight
    and bias are facegen's scale and bias."""
    prefix, name = key.rsplit(".", 1)
    a = t.detach().cpu().numpy()
    is_state = name in ("running_mean", "running_var")
    if is_state:
        leaf = name[len("running_"):]
    elif prefix in bn_prefixes:
        leaf = "scale" if name == "weight" else "bias"
    elif name == "bias":
        leaf = "b"
    elif a.ndim == 1:  # PReLU slope
        leaf = "a"
    else:
        leaf = "w"
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return is_state, "/".join([*prefix.split("."), leaf]), np.ascontiguousarray(a)


def _bn_prefixes(sd) -> set:
    return {k.rsplit(".", 1)[0] for k in sd if k.endswith(".running_mean")}


def jax_to_torch(arrays: Dict[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Checkpoint leaves -> {"g": state_dict, "d": state_dict}."""
    out = {"g": {}, "d": {}}
    for key, arr in arrays.items():
        root, _, path = key.partition("/")
        if root in _ROOTS:
            name, t = _torch_leaf(path, arr)
            out[_ROOTS[root]][name] = t
    return out


def torch_to_jax(state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """{"g": state_dict, "d": state_dict} -> checkpoint leaves."""
    arrays = {}
    for net, sd in state_dicts.items():
        bn = _bn_prefixes(sd)
        for key, t in sd.items():
            is_state, path, a = _jax_leaf(key, t, bn)
            arrays[f"{_NETS[net][is_state]}/{path}"] = a
    return arrays


_COUNTERS = ("accs", "accs_n", "confusion", "trained_d", "not_trained_d")


def _counters(state):
    return [key for key in _COUNTERS if hasattr(state, key)]


def train_state_arrays(state) -> Dict[str, np.ndarray]:
    """Every leaf of a training state (a GanState or a C2FState) under
    facegen's path of that leaf."""
    arrays = torch_to_jax({"g": state.g.state_dict(), "d": state.d.state_dict()})
    for net, module, opt in (("g", state.g, state.opt_g), ("d", state.d, state.opt_d)):
        bn = _bn_prefixes(module.state_dict())
        names = [n for n, _ in module.named_parameters()]
        for kind, value in opt.items():
            if kind == "count":
                arrays[f"opt_{net}/0/count"] = value.cpu().numpy().astype(np.int32)
                continue
            for name, t in zip(names, value):
                _, path, a = _jax_leaf(name, t, bn)
                arrays[f"opt_{net}/0/{kind}/{path}"] = a
    for key in _counters(state):
        arrays[key] = getattr(state, key).cpu().numpy()
    arrays["epoch"] = np.asarray(state.epoch, np.int32)
    return arrays


def save_train_state(directory: str, name: str, state, meta: Optional[dict] = None) -> str:
    """Write a whole training state, with ``.old`` rotation."""
    return save(directory, name, train_state_arrays(state), meta)


@torch.no_grad()
def load_train_state(directory: str, name: str, state) -> dict:
    """Load a checkpoint into ``state`` in place (parameters, statistics,
    optimizer state, counters, epoch). Strict: every leaf the state has
    must be there with its shape; leaves of other trees are ignored, as
    facegen's ckpt.load does. Returns the checkpoint's meta."""
    arrays, meta = load(directory, name)
    expected = train_state_arrays(state)
    missing = sorted(set(expected) - set(arrays))
    if missing:
        raise KeyError(f"checkpoint {os.path.join(directory, name)!r} lacks {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    for key, want in expected.items():
        if tuple(np.shape(arrays[key])) != want.shape:
            raise ValueError(f"checkpoint leaf {key!r} shape {np.shape(arrays[key])} "
                             f"!= {want.shape}")
    sds = jax_to_torch(arrays)
    state.g.load_state_dict(sds["g"], strict=True)
    state.d.load_state_dict(sds["d"], strict=True)
    for net, module, opt in (("g", state.g, state.opt_g), ("d", state.d, state.opt_d)):
        index = {n: i for i, (n, _) in enumerate(module.named_parameters())}
        for kind, value in opt.items():
            if kind == "count":
                value.copy_(torch.as_tensor(arrays[f"opt_{net}/0/count"]))
                continue
            prefix = f"opt_{net}/0/{kind}/"
            for key in expected:
                if key.startswith(prefix):
                    pname, t = _torch_leaf(key[len(prefix):], arrays[key])
                    value[index[pname]].copy_(t)
    for key in _counters(state):
        getattr(state, key).copy_(torch.as_tensor(arrays[key]))
    state.epoch = int(arrays["epoch"])
    return meta


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
