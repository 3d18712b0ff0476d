"""Carry model state between the JAX package and the port, in memory.

The state is what a checkpoint holds: the config as its manifest stores
it (``dataclasses.asdict`` of the JAX ``HDCConfig``, JAX backend names)
and the leaves by their checkpoint keys, as numpy arrays::

    {"codebooks/sobol": (H, D) int8 (uhd), or "codebooks/direction":
     (H, 32) uint8 (uhd_dynamic), "class_sums": (C, D) int32,
     "n_seen": (2,) uint32 [hi, lo]}

uint32 arrays cross as int32 bit patterns (``arr.view(np.int32)``);
codebooks keep their stored dtype (the int8 or int32 threshold table,
the narrow unsigned direction matrix), checked against the encoder's
``codebook_specs``.

An LM's parameters cross as the nested dict of JAX's ``init_params``
(``blocks/sub{i}/...`` stacked over the layer groups, ``tail/layer{i}/...``,
``embed``, ``final_norm``, ``unembed``), each leaf a numpy array, checked
by key path and shape against the port's spec tree.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.hdc_model import HDCModel, nseen_array, nseen_int
from repro_torch.core.model import config_from_manifest, manifest_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import param_specs


def model_from_jax_state(
    cfg: dict[str, Any], state: dict[str, np.ndarray], device: torch.device | str | None = None
) -> HDCModel:
    """An `HDCModel` on `device` from a JAX model's config dict and leaves."""
    config = config_from_manifest(dict(cfg))
    books = {
        key.split("/", 1)[1]: torch.from_numpy(np.array(arr))
        for key, arr in state.items()
        if key.startswith("codebooks/")
    }
    specs = registry.get_encoder(config.encoder).codebook_specs(config)
    for name, (shape, dtype) in specs.items():
        got = books.get(name)
        if got is not None and (tuple(got.shape) != shape or got.numpy().dtype != dtype):
            raise ValueError(
                f"codebook {name!r} is {tuple(got.shape)} {got.numpy().dtype}; encoder "
                f"{config.encoder!r} expects {shape} {np.dtype(dtype)}"
            )
    sums = np.array(state["class_sums"]).view(np.int32)
    n_seen = np.asarray(state["n_seen"])
    if n_seen.shape == (2,):
        n_seen = n_seen.view(np.int32)
    return HDCModel(config, books, torch.from_numpy(sums), nseen_int(n_seen), device=device)


def jax_state_from_model(model: HDCModel) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """Inverse of :func:`model_from_jax_state`: (config dict, leaves)."""
    state = {f"codebooks/{k}": v.cpu().numpy() for k, v in model.codebooks.items()}
    state["class_sums"] = model.class_sums.cpu().numpy()
    state["n_seen"] = nseen_array(model.n_seen)
    return manifest_config(model.cfg), state


def _leaf_to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_from_jax(cfg: ModelConfig, tree: dict, device: torch.device | str | None = None) -> dict:
    """The port's LM parameters on `device` (None: the card) from a JAX
    parameter tree of numpy arrays (``np.asarray`` of each leaf of
    ``repro.models.params.init_params``).  Raises on a missing or extra
    key or a shape that differs from the spec tree."""
    from repro_torch.core.hdc_model import resolve_device

    dev = resolve_device(device)

    def walk(specs: dict, sub: dict, path: str) -> dict:
        if set(specs) != set(sub):
            raise ValueError(f"LM params at {path or '/'}: keys {sorted(sub)}, "
                             f"{cfg.name} has {sorted(specs)}")
        out = {}
        for k, spec in specs.items():
            if isinstance(spec, dict):
                out[k] = walk(spec, sub[k], f"{path}{k}/")
                continue
            t = _leaf_to_torch(sub[k])
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"LM param {path}{k}: shape {tuple(t.shape)}, spec {spec.shape}")
            out[k] = t.to(dev)
        return out

    return walk(param_specs(cfg), tree, "")


def jax_params_from_lm(params: dict) -> dict:
    """Inverse of :func:`lm_params_from_jax`: the tree with numpy leaves."""
    return {k: jax_params_from_lm(v) if isinstance(v, dict) else _leaf_to_numpy(v)
            for k, v in params.items()}
