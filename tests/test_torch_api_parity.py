"""The port does all that ``repro`` does: every module of ``src/repro/``
has its counterpart in ``src/repro_torch/`` with every public top-level
name, apart from one explicit list of exclusions, each with its reason.

The name check reads both packages with ``ast`` and imports neither.  A
module's public names are the names it binds at top level without a
leading underscore: ``def``, ``class``, assignments, and names imported
from outside the package (``from jax.sharding import Mesh`` counts, as
it is a name the module offers; ``from repro.core import encoding`` is
wiring between the package's own modules and is checked where the name
is defined).  A package's ``__init__.py`` re-exports, so there every
imported name counts.  On the port's side any top-level binding, imports
included, is a counterpart.

Then the behaviour of the names added last: ``sobol.star_discrepancy_1d``,
``registry.encoder_names`` / ``backend_table``, the removed flat API's
tombstone, and the module-level ``hdc_model.fit`` / ``partial_fit`` /
``predict``.
"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: modules of ``repro`` without a counterpart module, and why
MODULE_EXCLUSIONS = {
    f"kernels/{name}.py": f"a Pallas TPU kernel; its hand-written CUDA counterpart is "
    f"kernels/csrc/{name}.cu, reached through kernels/ops.py as in the JAX package"
    for name in ("bundle_binarize", "encode_bundle", "encode_unary_mxu", "hamming_packed",
                 "hamming_topk")
}
_JAX_SHARDING = ("jax.sharding's type, imported for JAX's layout calls; the port's Mesh, "
                 "NamedSharding and PartitionSpec live in repro_torch.distributed.sharding")
_XLA_HLO = ("JAX's parser of the collectives in XLA's partitioned HLO text; the port compiles no "
            "HLO, and its dry-run counts the collectives its own sharded step sends "
            "(launch.dryrun.count_collectives)")
#: (module, name) of ``repro`` without a counterpart name, and why
NAME_EXCLUSIONS = {
    ("core/hdc_model.py", "Mesh"): _JAX_SHARDING,
    ("core/hdc_model.py", "NamedSharding"): _JAX_SHARDING,
    ("core/hdc_model.py", "P"): _JAX_SHARDING,
    ("distributed/sharding.py", "P"): _JAX_SHARDING + " (P is JAX's alias of PartitionSpec)",
    ("models/moe.py", "P"): _JAX_SHARDING,
    ("serving/execution.py", "P"): _JAX_SHARDING,
    ("distributed/compress.py", "partial"): "functools.partial, imported and unused in the "
    "JAX module (its jax.jit / shard_map wrappers are built without it)",
    ("launch/train.py", "Path"): "pathlib.Path, imported and unused in the JAX launcher",
    ("analysis/roofline.py", "collective_bytes"): _XLA_HLO,
}
#: names of the Pallas kernels' entry points: defined only in the excluded
#: Pallas modules and imported by ``repro.kernels.ops`` (the port's ops
#: wrappers launch the CUDA kernels under the same names less the suffix)
PALLAS_SUFFIX = "_pallas"


def _public_names(path: pathlib.Path, *, port: bool) -> set[str]:
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for n in [target] if isinstance(target, ast.Name) else getattr(target, "elts", []):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            internal = node.level > 0 or (node.module or "").split(".")[0] in ("repro",
                                                                             "repro_torch")
            if port or init or not internal:
                out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import) and port:
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _modules() -> list[str]:
    return sorted(str(p.relative_to(SRC / "repro")) for p in (SRC / "repro").rglob("*.py"))


def _missing(rel: str) -> set[str]:
    ours = SRC / "repro_torch" / rel
    if not ours.exists():
        return {"<module>"}
    theirs = _public_names(SRC / "repro" / rel, port=False)
    return theirs - _public_names(ours, port=True)


@pytest.mark.parametrize("rel", _modules())
def test_every_repro_module_has_its_counterpart_with_every_public_name(rel):
    missing = _missing(rel)
    if rel in MODULE_EXCLUSIONS:
        assert missing == {"<module>"}, f"{rel} is excluded, yet the port has it"
        return
    unexplained = sorted(n for n in missing if (rel, n) not in NAME_EXCLUSIONS)
    assert not unexplained, f"repro_torch/{rel} lacks {unexplained}"


def test_every_exclusion_is_needed_and_says_why():
    for rel, reason in MODULE_EXCLUSIONS.items():
        assert (SRC / "repro" / rel).exists() and reason
        assert _missing(rel) == {"<module>"}
    for (rel, name), reason in NAME_EXCLUSIONS.items():
        assert name in _missing(rel), f"{rel}:{name} is excluded but has a counterpart"
        assert "jax" in reason.lower() or "unused" in reason
    # the Pallas entry points live only in the excluded modules
    for rel in _modules():
        names = _public_names(SRC / "repro" / rel, port=False)
        pallas = {n for n in names if n.endswith(PALLAS_SUFFIX)}
        assert not pallas or rel in MODULE_EXCLUSIONS, (rel, pallas)


# -- the names added last, against the JAX package ---------------------------


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_star_discrepancy_1d_equals_jax_on_sobol_and_random_points(n):
    from repro.core import sobol as jsobol
    from repro_torch.core import sobol as tsobol

    pts = tsobol.sobol_sequence(3, n, seed=0)
    for row in list(pts.T) + [np.random.default_rng(n).random(n)]:
        assert tsobol.star_discrepancy_1d(row) == jsobol.star_discrepancy_1d(row)


def test_encoder_names_equal_jax_and_backend_table_keys_are_the_encoders():
    from repro.core import registry as jreg
    from repro_torch.core import Encoder, encoder_names
    from repro_torch.core import registry as treg

    assert encoder_names() == jreg.encoder_names()
    table = treg.backend_table()
    assert tuple(sorted(table)) == encoder_names()
    for enc, backends in table.items():
        assert sorted(backends) == ["cuda", "ref"]
        assert isinstance(treg.get_encoder(enc), Encoder)
    table["uhd"].clear()  # a snapshot: the registry is untouched
    assert treg.backend_names("uhd") == ("cuda", "ref")


@pytest.mark.parametrize("module", ["repro_torch.core", "repro_torch.core.model"])
@pytest.mark.parametrize("name", ["build_codebooks", "encode", "fit", "fit_streaming",
                                  "predict", "evaluate"])
def test_removed_flat_api_raises_naming_the_hdcmodel_replacement(module, name):
    import importlib

    mod = importlib.import_module(module)
    with pytest.raises(AttributeError, match="HDCModel"):
        getattr(mod, name)
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(mod, "no_such_name")


def test_module_level_fit_partial_fit_predict_are_the_methods_datapath():
    from repro_torch.core import HDCConfig, HDCModel, hdc_model

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (48, 32)).astype(np.float32)
    y = rng.integers(0, 4, 48).astype(np.int32)
    model = HDCModel.create(HDCConfig(n_features=32, n_classes=4, d=256), device="cpu")
    a, b = model.fit(x[:24], y[:24]), hdc_model.fit(model, x[:24], y[:24])
    assert np.array_equal(a.class_sums.numpy(), b.class_sums.numpy()) and a.n_seen == b.n_seen
    a2, b2 = a.partial_fit(x[24:], y[24:]), hdc_model.partial_fit(b, x[24:], y[24:])
    assert np.array_equal(a2.class_sums.numpy(), b2.class_sums.numpy()) and a2.n_seen == 48
    assert np.array_equal(a2.predict(x).numpy(), hdc_model.predict(b2, x).numpy())
    # the JAX package's module-level functions give the same sums and labels
    from repro.core import HDCConfig as JConfig, HDCModel as JModel, hdc_model as jhdc

    jm = jhdc.partial_fit(jhdc.fit(JModel.create(JConfig(n_features=32, n_classes=4, d=256)),
                                   x[:24], y[:24]), x[24:], y[24:])
    assert np.array_equal(np.asarray(jm.class_sums), b2.class_sums.numpy())
    assert np.array_equal(np.asarray(jhdc.predict(jm, x)), hdc_model.predict(b2, x).numpy())
    # the methods are the module functions, not a second copy of the datapath
    import inspect

    for name in ("fit", "partial_fit", "predict"):
        assert f"return {name}(self" in inspect.getsource(getattr(HDCModel, name))
