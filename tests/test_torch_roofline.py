"""The port's roofline (`repro_torch.launch.roofline`) against the JAX
package's `repro.launch.roofline`, on the same records.

The port's `roofline_terms` takes a hardware row; given one built from the
JAX module's TPU constants (read here, at test time), every function must
return what the JAX function returns, exactly: the terms, the model FLOPs,
the rendered table and each formatted number, for train, prefill and
decode records on both production meshes and for skipped and failed
records. A second case checks the H100 default row.
"""

import json
import os

import pytest

from repro.launch import roofline as jroof
from repro_torch.launch import roofline as troof

JAX_ROW = troof.Hardware(name="tpu-v5e", peak_flops=jroof.PEAK_FLOPS,
                         hbm_bw=jroof.HBM_BW, link_bw=jroof.LINK_BW,
                         pod_bw=jroof.DCN_BW)
SINGLE, MULTI = {"data": 16, "model": 16}, {"pod": 2, "data": 16,
                                             "model": 16}


def _rec(arch, shape, kind, mesh, mname, flops, nbytes, coll, temp):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return {"arch": arch, "shape": shape, "kind": kind, "mesh": mesh,
            "_mesh_name": mname, "num_microbatches": 8,
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "memory": {"argument_size_in_bytes": 1 << 20,
                       "output_size_in_bytes": 1 << 20,
                       "temp_size_in_bytes": temp},
            "cost": {"flops": flops, "bytes accessed": nbytes},
            "collectives": {"total_bytes": coll}}


RECORDS = [
    _rec("qwen1.5-0.5b", "train_4k", "train", SINGLE, "pod16x16",
         2.0e13, 2.3e12, 4.19e10, 1_322_612_772),
    _rec("gemma2-9b", "prefill_32k", "prefill", MULTI, "pod2x16x16",
         5.5e13, 7.5e11, 4.5e10, 6_641_000_000),
    _rec("deepseek-moe-16b", "decode_32k", "decode", SINGLE, "pod16x16",
         2.7e7, 3.1e10, 4.2e9, 138_000_000),
    _rec("zamba2-1.2b", "long_500k", "decode", MULTI, "pod2x16x16",
         0.0, 0.0, 0.0, 0),
    _rec("hubert-xlarge", "train_4k", "train", MULTI, "pod2x16x16",
         1.0e3, 2.0e3, 3.0e3, 7),
    _rec("mamba2-370m", "train_4k", "train", SINGLE, "pod16x16",
         1e30, 1e30, 1e30, 10 ** 12),
]
SKIPPED = {"arch": "gemma2-9b", "shape": "long_500k", "mesh": SINGLE,
           "_mesh_name": "pod16x16",
           "skipped": "full attention is quadratic at 500k"}
FAILED = {"arch": "qwen1.5-0.5b", "shape": "train_4k", "mesh": MULTI,
          "_mesh_name": "pod2x16x16", "error": "boom"}


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: f"{r['arch']}-"
                         f"{r['shape']}-{r['_mesh_name']}")
def test_terms_match_jax(rec):
    assert troof.analytic_flops_per_chip(rec) == \
        jroof.analytic_flops_per_chip(rec)
    assert troof._tokens_of(rec) == jroof._tokens_of(rec)
    want = jroof.roofline_terms(rec)
    got = troof.roofline_terms(rec, JAX_ROW)
    assert got == want


def test_skipped_and_failed_records_have_no_terms():
    for rec in (SKIPPED, FAILED):
        assert jroof.roofline_terms(rec) is None
        assert troof.roofline_terms(rec, JAX_ROW) is None
        assert troof.roofline_terms(rec) is None


@pytest.mark.parametrize("markdown", [False, True])
def test_render_matches_jax(markdown):
    rows = [jroof.roofline_terms(r) for r in RECORDS]
    assert troof.render(rows, markdown) == jroof.render(rows, markdown)
    assert troof.render([troof.roofline_terms(r, JAX_ROW) for r in RECORDS],
                        markdown) == jroof.render(rows, markdown)


@pytest.mark.parametrize("v", [0.0, 1e-4, 1e-3, 0.5, 12.25, 9999.0, 1e4,
                               -3e-5, 3, "memory", None, float("inf")])
def test_fmt_matches_jax(v):
    assert troof._fmt(v) == jroof._fmt(v)


def test_h100_default_row():
    row = troof.H100
    assert row.peak_flops == 989e12
    assert row.hbm_bw == 3.35e12
    assert row.link_bw == 450e9 == 18 * 25e9
    assert row.pod_bw == 400e9 / 8
    rec = RECORDS[0]
    got = troof.roofline_terms(rec)
    model = jroof.analytic_flops_per_chip(rec)
    assert got["t_compute_s"] == max(rec["cost"]["flops"], model) / 989e12
    assert got["t_memory_s"] == rec["cost"]["bytes accessed"] / 3.35e12
    assert got["t_collective_s"] == rec["collectives"]["total_bytes"] / 450e9
    assert got["bound_time_s"] == max(got["t_compute_s"], got["t_memory_s"],
                                      got["t_collective_s"])
    src = open(troof.__file__).read()
    for tpu in ("197e12", "819e9", "6.25e9"):
        assert tpu not in src


def test_load_cells_and_main(tmp_path, capsys):
    for rec in RECORDS[:3] + [SKIPPED]:
        name = f"{rec['arch']}__{rec['shape']}__{rec['_mesh_name']}.json"
        body = {k: v for k, v in rec.items() if k != "_mesh_name"}
        with open(os.path.join(tmp_path, name), "w") as f:
            json.dump(body, f)
    cells = troof.load_cells(str(tmp_path))
    assert cells == jroof.load_cells(str(tmp_path))
    assert [c["_mesh_name"] for c in troof.load_cells(
        str(tmp_path), "pod16x16")] == ["pod16x16"] * 3
    out = tmp_path / "table.txt"
    text = troof.main(["--dir", str(tmp_path), "--out", str(out)])
    assert text + "\n" == out.read_text()
    assert "skipped cells:" in text and "quadratic" in text
    # the header, 3 rows, a blank line, the skip heading and the skip
    assert len(text.splitlines()) == 1 + 3 + 1 + 1 + 1
