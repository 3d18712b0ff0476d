"""The port's scoring policies against the JAX package.

``HDCConfig`` carries four policies that the default configurations
leave at their defaults: ``class_binarize`` ("auto", "sign", "none"),
``pack_center`` ("auto", "row", "none"), ``binarize_query`` and
``similarity`` ("cosine", "dot", "hamming").  Each encoder is fitted once
in both packages at D = 300 on 160 ``synth_mnist`` images (the policies
do not change the class sums); each case then gives both models the
same policies and compares class HVs, ``predict``, ``pack``,
``predict_packed`` and ``evaluate``.  The datapath is integer arithmetic
and float32 scores that agree here, so every comparison is **exact
equality** (no tolerance).  ``ShardedExecution`` on four CPU shards is
held to ``DeviceExecution`` under one non-default policy per encoder.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import HDCConfig, HDCModel
from repro_torch.core import hdc_model as thm
from repro_torch.data import load_dataset
from repro_torch.serving import DeviceExecution, ShardedExecution

try:  # the card's machine runs no JAX
    import jax
    import jax.numpy as jnp

    from repro.core import HDCConfig as JConfig
    from repro.core import HDCModel as JModel
    from repro.core import hdc_model as jhm
except ModuleNotFoundError:
    jax = None

ENCODERS = ("uhd", "uhd_dynamic", "baseline")
D_POLICY = 300


@pytest.fixture
def jax_side():
    if jax is None:
        pytest.skip("needs the JAX package")


@functools.lru_cache(maxsize=None)
def _data():
    return load_dataset("synth_mnist", n_train=160, n_test=32)


def _kw(encoder: str, d: int) -> dict:
    return dict(n_features=784, n_classes=10, d=d, levels=16, encoder=encoder)


@functools.lru_cache(maxsize=None)
def _port(encoder: str, d: int) -> HDCModel:
    ds = _data()
    return HDCModel.create(HDCConfig(**_kw(encoder, d)), device="cpu").fit(
        ds.train_images, ds.train_labels
    )


@functools.lru_cache(maxsize=None)
def _jax(encoder: str):
    ds = _data()
    return JModel.create(JConfig(**_kw(encoder, D_POLICY))).fit(
        jnp.asarray(ds.train_images), jnp.asarray(ds.train_labels)
    )


def _policy_model(encoder: str, **policy) -> HDCModel:
    tm = _port(encoder, D_POLICY)
    return HDCModel(dataclasses.replace(tm.cfg, **policy), tm.codebooks, tm.class_sums, tm.n_seen,
                    device="cpu")


COMBOS = [(q, s) for q in (False, True) for s in ("cosine", "dot", "hamming")]


def _jax_labels(encoder: str, images, **policy):
    """JAX's ``predict`` labels for every (binarize_query, similarity) of
    COMBOS and its ``predict_packed`` labels for each binarize_query, from
    the JAX package's own jitted functions, traced together under one
    ``jax.jit`` so a case compiles once.  The models share the fitted
    model's leaves; ``predict_packed`` (``search_packed``) reads neither
    ``similarity`` nor ``class_binarize`` (the class words come in), so it
    runs once per binarize_query, on the words ``pack()`` gives."""
    jm = _jax(encoder)
    cfgs = [dataclasses.replace(jm.cfg, **policy, binarize_query=q, similarity=s)
            for q, s in COMBOS]

    def labels(books, sums, n_seen, x):
        models = [jm.replace(cfg=c, codebooks=books, class_sums=sums, n_seen=n_seen) for c in cfgs]
        packed = {m.cfg.binarize_query: jhm.predict_packed(m, x, m.pack())
                  for m in models if m.cfg.similarity == "cosine"}
        return [jhm.predict(m, x) for m in models], packed

    pred, packed = jax.jit(labels)(jm.codebooks, jm.class_sums, jm.n_seen, jnp.asarray(images))
    return [np.asarray(p) for p in pred], {q: np.asarray(p) for q, p in packed.items()}


@pytest.mark.parametrize("pack_center", ["auto", "row", "none"])
@pytest.mark.parametrize("class_binarize", ["auto", "sign", "none"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_policies_equal_jax(jax_side, encoder, class_binarize, pack_center):
    ds = _data()
    images, labels = ds.test_images, ds.test_labels
    policy = dict(class_binarize=class_binarize, pack_center=pack_center)
    jm = _jax(encoder)
    np.testing.assert_array_equal(_port(encoder, D_POLICY).class_sums.numpy(),
                                  np.asarray(jm.class_sums))
    jpred, jpacked = _jax_labels(encoder, images, **policy)
    for (binarize_query, similarity), want in zip(COMBOS, jpred):
        what = f"binarize_query={binarize_query} similarity={similarity}"
        t = _policy_model(encoder, **policy, binarize_query=binarize_query, similarity=similarity)
        j = jm.replace(cfg=dataclasses.replace(jm.cfg, **policy, binarize_query=binarize_query,
                                               similarity=similarity))
        np.testing.assert_array_equal(t.class_hvs.numpy(), np.asarray(j.class_hvs))
        words = t.pack()
        np.testing.assert_array_equal(words.numpy(), np.asarray(j.pack()).view(np.int32))
        np.testing.assert_array_equal(t.predict(images).numpy(), want, err_msg=what)
        np.testing.assert_array_equal(thm.predict_packed(t, images, words).numpy(),
                                      jpacked[binarize_query], err_msg=what)
        # JAX's evaluate is the share of its predict labels that are right
        assert t.evaluate(images, labels) == float(np.mean(want == labels)), what


# one non-default combination per encoder (class_binarize, binarize_query, pack_center)
_SHARDED = {
    "uhd": dict(class_binarize="none", binarize_query=True, pack_center="none"),
    "uhd_dynamic": dict(class_binarize="sign", binarize_query=False, pack_center="row"),
    "baseline": dict(class_binarize="none", binarize_query=True, pack_center="row"),
}


@pytest.mark.parametrize("d", [256, 320])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_sharded_execution_equals_device_under_policy(encoder, d):
    ds = _data()
    model = _port(encoder, d)
    model = HDCModel(dataclasses.replace(model.cfg, **_SHARDED[encoder]), model.codebooks,
                     model.class_sums, model.n_seen, device="cpu")
    device, sharded = DeviceExecution(device="cpu"), ShardedExecution(devices=["cpu"] * 4)
    words, parts = device.pack(model), sharded.pack(model)
    images = ds.test_images
    assert torch.equal(sharded.predict(model, parts, images), device.predict(model, words, images))
    idx, dist = sharded.search(model, parts, images, 3)
    want_i, want_d = device.search(model, words, images, 3)
    assert torch.equal(idx, want_i) and torch.equal(dist, want_d)
