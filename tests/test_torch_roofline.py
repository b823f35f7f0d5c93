"""Port parity: the roofline analysis (``repro_torch.launch.roofline``)
against the JAX package's ``benchmarks/roofline.py`` formulas.

``model_flops_per_device`` is 6 (train) or 2 (prefill, decode) times the
active parameters times the tokens, per chip, from the reference's
configs, for all 80 (arch, shape, mesh) records; ``analyze_record``'s
three terms and dominant term match a record worked by hand on the H100's
figures; ``load_capture`` skips ``fail`` records and keeps the last
record of a case.
"""
import json

import pytest

from repro.configs import ARCHITECTURES, INPUT_SHAPES
from repro.configs import get_arch as jget_arch
from repro_torch.launch import roofline
from repro_torch.launch.mesh import HW


def _records():
    for arch in sorted(ARCHITECTURES):
        for shape in INPUT_SHAPES:
            for multi_pod in (False, True):
                yield {"arch": arch, "shape": shape.name, "kind": shape.kind,
                       "multi_pod": multi_pod}, shape


def test_model_flops_per_device_all_80_records():
    n = 0
    for rec, shape in _records():
        cfg = jget_arch(rec["arch"])
        mult = 6 if shape.kind == "train" else 2
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        chips = 512 if rec["multi_pod"] else 256
        want = mult * cfg.active_param_count() * tokens / chips
        assert roofline.model_flops_per_device(rec) == pytest.approx(want,
                                                                     rel=1e-12)
        n += 1
    assert n == 80


def test_analyze_record_by_hand():
    rec = {"arch": "minitron-8b", "shape": "prefill_32k", "kind": "prefill",
           "multi_pod": False, "flops": 9.89e13, "bytes_accessed": 7.65e11,
           "collectives": {"total_bytes": 1.0e11, "total_ring_cost_bytes": 9.0e10,
                           "by_group": {"16": 8.0e10, "8": 1.0e10}},
           "memory": {"temp_size_in_bytes": 2.5e9}}
    out = roofline.analyze_record(rec)
    # 9.89e13 / 989e12 = 0.1 s; 7.65e11 / 3.35e12 = 0.2284 s;
    # 8e10 / 50e9 (a 16-GPU group spans nodes) + 1e10 / 900e9 = 1.6111 s
    assert out["compute_s"] == pytest.approx(0.1)
    assert out["memory_s"] == pytest.approx(7.65e11 / 3.35e12)
    assert out["collective_s"] == pytest.approx(1.6 + 1.0e10 / 900e9)
    assert out["dominant"] == "collective"
    assert out["bound_s"] == out["collective_s"]
    assert out["hbm_gb"] == 2.5
    assert out["useful_ratio"] == pytest.approx(
        roofline.model_flops_per_device(rec) / 9.89e13)
    # a record without group sizes (the reference's) prices its ring bytes
    # at the 16-device axis' link
    del rec["collectives"]["by_group"]
    assert roofline.analyze_record(rec)["collective_s"] == pytest.approx(
        9.0e10 / HW.INTER_NODE_BW)


def test_link_bandwidth_by_group_size():
    assert HW.link_bw(8) == HW.NVLINK_BW
    assert HW.link_bw(16) == HW.INTER_NODE_BW == 50e9


def test_load_capture_skips_failures(tmp_path):
    ok = {"arch": "mamba2-370m", "shape": "decode_32k", "kind": "decode",
          "multi_pod": False, "flops": 1.0e9, "bytes_accessed": 1.0e9,
          "collectives": {"total_bytes": 0, "total_ring_cost_bytes": 0.0},
          "memory": {}, "status": "ok"}
    path = tmp_path / "cap.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({**ok, "flops": 5.0}) + "\n")
        f.write(json.dumps(ok) + "\n")
        f.write(json.dumps({"arch": "qwen2.5-32b", "shape": "train_4k",
                            "multi_pod": False, "status": "fail",
                            "error": "x"}) + "\n")
    rows = roofline.load_capture(str(path))
    assert len(rows) == 1 and rows[0]["arch"] == "mamba2-370m"
    assert rows[0]["compute_s"] == pytest.approx(1.0e9 / HW.PEAK_FLOPS_BF16)
    assert "mamba2-370m" in roofline.format_table(rows)
    assert roofline.load_capture(str(tmp_path / "missing.jsonl")) == []
