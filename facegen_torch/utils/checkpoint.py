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

On a 2-D mesh (parallel/gspmd.py) a state's optimizer moments are this
rank's shards (``state.shards``): ``train_state_arrays`` gathers them into
full tensors over the model group, a collective that every rank of the
mesh makes, and ``load_train_state`` reads the full leaves and keeps this
rank's shards. The nets' parameters are full on every rank (the gathered
work weights). A checkpoint is thus facegen's layout whatever the mesh
it was saved on, and resumes on one device or on any mesh.

A StyleGAN2 checkpoint (models/stylegan2.py) keeps its nets' state
dicts as they are, keyed ``G/<key>`` and ``D/<key>`` in torch's layouts
(``G/synthesis.b4.conv1.weight``, the const noise ``…noise_const`` and
``G/mapping.w_avg`` included); meta.json's "config" holds ``arch``
("stylegan2") and the widths ``restore_gan`` rebuilds it from. facegen
has no such net and does not read it.

The autoencoder family's checkpoints (facegen/train/ae_loop.py) use the
same leaf mapping under other roots: ``autoencoder`` holds ``params/…``,
``state/…`` (none: the flat AE has no batch norm) and Adam's
``opt/0/{count,mu,nu}/…``; ``denoiser_{c}x{h}x{w}`` holds
``AE1_DECODER/{params,state}/…`` and ``AE2_DECODER/{params,state}/…``
(its ``AE1_ENCODER``, a white-noise layer, has no leaves) and no
optimizer state.
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

from facegen_torch.parallel.gspmd import gather_params

FORMAT_VERSION = 1

# checkpoint tree roots of G's and D's parameters and statistics
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


def _sd_arrays(sd, params_root: str, state_root: str) -> Dict[str, np.ndarray]:
    """A state_dict -> its leaves under ``params_root`` (parameters) and
    ``state_root`` (batch-norm statistics)."""
    bn = _bn_prefixes(sd)
    arrays = {}
    for key, t in sd.items():
        is_state, path, a = _jax_leaf(key, t, bn)
        arrays[f"{state_root if is_state else params_root}/{path}"] = a
    return arrays


def _sd_from_arrays(arrays: Dict[str, np.ndarray], *roots: str) -> Dict[str, torch.Tensor]:
    """The state_dict held by the leaves under ``roots``."""
    sd = {}
    for key, arr in arrays.items():
        for root in roots:
            if key.startswith(root + "/"):
                name, t = _torch_leaf(key[len(root) + 1:], arr)
                sd[name] = t
    return sd


def jax_to_torch(arrays: Dict[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Checkpoint leaves -> {"g": state_dict, "d": state_dict}."""
    return {net: _sd_from_arrays(arrays, *roots) for net, roots in _NETS.items()}


def torch_to_jax(state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """{"g": state_dict, "d": state_dict} -> checkpoint leaves."""
    arrays = {}
    for net, sd in state_dicts.items():
        arrays.update(_sd_arrays(sd, *_NETS[net]))
    return arrays


def module_arrays(module: nn.Module, params_root: str, state_root: str,
                  opt: Optional[dict] = None, opt_root: Optional[str] = None
                  ) -> Dict[str, np.ndarray]:
    """A module's leaves under facegen's paths, and with ``opt`` its
    optimizer state's under ``opt_root``: ``{opt_root}/0/count`` and
    ``{opt_root}/0/{mu,nu,...}/<parameter path>``, as optax lays them out."""
    arrays = _sd_arrays(module.state_dict(), params_root, state_root)
    if opt is None:
        return arrays
    bn = _bn_prefixes(module.state_dict())
    names = [n for n, _ in module.named_parameters()]
    for kind, value in opt.items():
        if kind == "count":
            arrays[f"{opt_root}/0/count"] = value.cpu().numpy().astype(np.int32)
            continue
        for name, t in zip(names, value):
            _, path, a = _jax_leaf(name, t, bn)
            arrays[f"{opt_root}/0/{kind}/{path}"] = a
    return arrays


@torch.no_grad()
def load_module_arrays(arrays: Dict[str, np.ndarray], module: nn.Module, params_root: str,
                       state_root: str, opt: Optional[dict] = None,
                       opt_root: Optional[str] = None) -> None:
    """``module_arrays``'s inverse, in place: every parameter and buffer
    must be there (strict), and with ``opt`` every optimizer leaf."""
    module.load_state_dict(_sd_from_arrays(arrays, params_root, state_root), strict=True)
    if opt is None:
        return
    index = {n: i for i, (n, _) in enumerate(module.named_parameters())}
    for kind, value in opt.items():
        if kind == "count":
            value.copy_(torch.as_tensor(arrays[f"{opt_root}/0/count"]))
            continue
        prefix = f"{opt_root}/0/{kind}/"
        for key, arr in arrays.items():
            if key.startswith(prefix):
                pname, t = _torch_leaf(key[len(prefix):], arr)
                value[index[pname]].copy_(t)


def _load_checked(directory: str, name: str, expected: Dict[str, np.ndarray]):
    """(arrays, meta) of a checkpoint that holds every leaf of ``expected``
    with its shape; leaves of other trees are ignored, as facegen's
    ckpt.load does."""
    arrays, meta = load(directory, name)
    missing = sorted(set(expected) - set(arrays))
    if missing:
        raise KeyError(f"checkpoint {os.path.join(directory, name)!r} lacks {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    for key, want in expected.items():
        if tuple(np.shape(arrays[key])) != want.shape:
            raise ValueError(f"checkpoint leaf {key!r} shape {np.shape(arrays[key])} "
                             f"!= {want.shape}")
    return arrays, meta


_COUNTERS = ("accs", "accs_n", "confusion", "trained_d", "not_trained_d")


def _counters(state):
    return [key for key in _COUNTERS if hasattr(state, key)]


def train_state_arrays(state) -> Dict[str, np.ndarray]:
    """Every leaf of a training state (a GanState or a C2FState) under
    facegen's path of that leaf. On a 2-D mesh every rank calls it (the
    moments' shards are gathered)."""
    arrays = {}
    opts = gather_params(getattr(state, "shards", None), {"g": state.opt_g, "d": state.opt_d})
    for net, module in (("g", state.g), ("d", state.d)):
        arrays.update(module_arrays(module, *_NETS[net], opts[net], f"opt_{net}"))
    for key in _counters(state):
        arrays[key] = getattr(state, key).cpu().numpy()
    arrays["epoch"] = np.asarray(state.epoch, np.int32)
    return arrays


def save_train_state(directory: str, name: str, state, meta: Optional[dict] = None,
                     write: bool = True) -> Optional[str]:
    """Write a whole training state, with ``.old`` rotation. On a 2-D mesh
    every rank calls it and the one with ``write`` writes."""
    arrays = train_state_arrays(state)
    return save(directory, name, arrays, meta) if write else None


@torch.no_grad()
def load_train_state(directory: str, name: str, state) -> dict:
    """Load a checkpoint into ``state`` in place (parameters, statistics,
    optimizer state, counters, epoch). Strict: every leaf the state has
    must be there with its shape; leaves of other trees are ignored, as
    facegen's ckpt.load does. On a 2-D mesh the full leaves are read and
    this rank keeps its shards. Returns the checkpoint's meta."""
    shards = getattr(state, "shards", None)
    full = state
    if shards is not None:  # full moments to read into, shards taken after
        full = dataclasses.replace(state, shards=None, **{
            f"opt_{k}": {kind: [torch.zeros_like(p) for p in shards[k].params]
                         if isinstance(v, list) else v.clone() for kind, v in opt.items()}
            for k, opt in (("g", state.opt_g), ("d", state.opt_d))})
    arrays, meta = _load_checked(directory, name, train_state_arrays(full))
    for net, module, opt in (("g", full.g, full.opt_g), ("d", full.d, full.opt_d)):
        load_module_arrays(arrays, module, *_NETS[net], opt, f"opt_{net}")
    for key in _counters(state):
        getattr(state, key).copy_(torch.as_tensor(arrays[key]))
    state.epoch = int(arrays["epoch"])
    if shards is not None:
        for k, opt, opt_full in (("g", state.opt_g, full.opt_g), ("d", state.opt_d, full.opt_d)):
            shards[k].pull_()
            shards[k].load_opt_(opt, opt_full)
    return meta


def exists(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, name, "arrays.npz"))


def autoencoder_arrays(model: nn.Module, opt: dict) -> Dict[str, np.ndarray]:
    """The flat AE's checkpoint leaves: ``params/…``, ``state/…`` and
    Adam's ``opt/0/…`` (facegen/train/ae_loop.py:185-187)."""
    return module_arrays(model, "params", "state", opt, "opt")


def save_autoencoder(directory: str, name: str, model: nn.Module, opt: dict,
                     meta: Optional[dict] = None) -> str:
    return save(directory, name, autoencoder_arrays(model, opt), meta)


def load_autoencoder(directory: str, name: str, model: nn.Module, opt: dict) -> dict:
    """Load an ``autoencoder`` checkpoint into ``model`` and ``opt`` in
    place (strict); returns its meta."""
    arrays, meta = _load_checked(directory, name, autoencoder_arrays(model, opt))
    load_module_arrays(arrays, model, "params", "state", opt, "opt")
    return meta


_DECODERS = ("AE1_DECODER", "AE2_DECODER")


def denoiser_arrays(dec1: nn.Module, dec2: nn.Module) -> Dict[str, np.ndarray]:
    """The denoiser's checkpoint leaves: each decoder's ``params/…`` and
    ``state/…`` under its key (facegen/models/ae.py:99-103)."""
    arrays = {}
    for key, dec in zip(_DECODERS, (dec1, dec2)):
        arrays.update(module_arrays(dec, f"{key}/params", f"{key}/state"))
    return arrays


def save_denoiser(directory: str, name: str, dec1: nn.Module, dec2: nn.Module,
                  meta: Optional[dict] = None) -> str:
    return save(directory, name, denoiser_arrays(dec1, dec2), meta)


def load_denoiser(directory: str, name: str, dec1: nn.Module, dec2: nn.Module) -> dict:
    """Load a ``denoiser_{c}x{h}x{w}`` checkpoint into both decoders in
    place (strict, as facegen's ckpt.load of the whole bundle); returns
    its meta."""
    arrays, meta = _load_checked(directory, name, denoiser_arrays(dec1, dec2))
    for key, dec in zip(_DECODERS, (dec1, dec2)):
        load_module_arrays(arrays, dec, f"{key}/params", f"{key}/state")
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


def save_stylegan2(directory: str, name: str, g: nn.Module, d: nn.Module) -> str:
    """Write a StyleGAN2 G and D (``G/<key>``, ``D/<key>``) with
    ``g.cfg.meta()`` as meta.json's "config"."""
    arrays = {f"{net}/{k}": v.detach().cpu().numpy()
              for net, m in (("G", g), ("D", d)) for k, v in m.state_dict().items()}
    return save(directory, name, arrays, meta={"config": g.cfg.meta()})


@torch.no_grad()
def load_stylegan2(directory: str, name: str, g: nn.Module, d: nn.Module) -> dict:
    """Load a StyleGAN2 checkpoint into ``g`` and ``d`` (strict); returns its meta."""
    arrays, meta = load(directory, name)
    for net, m in (("G", g), ("D", d)):
        prefix = net + "/"
        m.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                           if k.startswith(prefix)}, strict=True)
    return meta
