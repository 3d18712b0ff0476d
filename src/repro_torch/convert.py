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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.hdc_model import HDCModel, nseen_array, nseen_int
from repro_torch.core.model import config_from_manifest, manifest_config


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
