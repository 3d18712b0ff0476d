"""``repro_torch.launch.dryrun.main`` at full width: qwen3-0.6b x train_4k
on the production mesh of 256 ``meta`` devices writes a record with the
keys of the JAX package's record, read from ``repro/launch/dryrun.py``
with ``ast`` (the JAX module forces 512 host devices at import, and JAX
at that size takes minutes to compile; the port runs the step on meta
tensors in under a minute).
"""

from __future__ import annotations

import ast
import json
import pathlib

import pytest

JAX_DRYRUN = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"


def _returned_keys(fn: ast.FunctionDef) -> set[str]:
    """Keys of the dict literal a function returns."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    raise AssertionError(f"{fn.name} returns no dict literal")


def jax_record_keys(roofline: bool) -> dict[str, set[str]]:
    """The top-level keys of JAX's ``run_cell`` record, and the keys of its
    ``memory`` and ``raw`` entries; the ``--roofline`` keys with `roofline`."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    run_cell = fns["run_cell"]
    top: set[str] = set()

    def visit(stmts, in_roofline: bool):
        for st in stmts:
            if isinstance(st, ast.If):
                gate = "do_roofline" in ast.unparse(st.test)
                visit(st.body, in_roofline or gate)
                continue
            if in_roofline and not roofline:
                continue
            if isinstance(st, ast.AnnAssign) and isinstance(st.value, ast.Dict) \
                    and ast.unparse(st.target) == "record":
                top.update(k.value for k in st.value.keys)
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Subscript) and ast.unparse(t.value) == "record":
                        top.add(t.slice.value)

    visit(run_cell.body, False)
    return {"top": top, "memory": _returned_keys(fns["_memory"]),
            "raw": _returned_keys(fns["_cell_stats"])}


def test_main_writes_a_record_with_jax_keys(tmp_path, capsys):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-0.6b__train_4k__single.json").read_text())
    want = jax_record_keys(roofline=False)
    assert {"arch", "shape", "mesh", "chips", "lower_s", "memory", "raw"} <= want["top"]
    assert want["top"] <= set(rec)
    assert want["memory"] <= set(rec["memory"]) and want["raw"] <= set(rec["raw"])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "qwen3-0.6b", "train_4k", "single", 256)
    # params (float32 masters, model-axis split), AdamW moments (ZeRO-1), batch, step
    mem = rec["memory"]
    assert mem["argument_bytes"] > mem["alias_bytes"] > 0
    assert mem["peak_bytes_est"] >= mem["argument_bytes"]
    assert rec["raw"]["flops"] * 256 == rec["raw"]["flops_global"] > rec["model_flops"] > 0
    assert "run" in capsys.readouterr().out


@pytest.mark.parametrize("arch,shape_name", [("olmoe-1b-7b", "decode_32k"),
                                             ("xlstm-1.3b", "long_500k")])
def test_roofline_fills_terms_from_the_counted_step(arch, shape_name):
    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, shape_name, do_roofline=True, verbose=False)
    want = jax_record_keys(roofline=True)
    assert want["top"] <= set(rec)
    terms = rec["terms"]
    assert terms["flops_dev"] == rec["raw"]["flops"] == rec["corrected"]["flops"]
    assert terms["compute_s"] == pytest.approx(terms["flops_dev"] / roofline.PEAK_FLOPS)
    assert terms["memory_s"] == pytest.approx(terms["bytes_dev"] / roofline.HBM_BW)
    assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    # the collectives of its sharded step on the 256-rank fake group: the
    # experts' all-to-alls among the MoE's, the xLSTM's blocks per shard
    assert rec["raw"]["coll_note"] == dryrun.COLL_NOTE
    assert terms["collective_s"] == pytest.approx(rec["raw"]["coll_bytes"] / roofline.LINK_BW)
    assert rec["raw"]["coll_bytes"] == sum(rec["raw"]["coll_by_type"].values()) > 0
    assert (rec["raw"]["coll_by_type"]["all-to-all"] > 0) == (arch == "olmoe-1b-7b")
    assert 0 < rec["useful_flops_ratio"]
