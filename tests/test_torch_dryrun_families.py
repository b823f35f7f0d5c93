"""Port: a reduced model of each family traces as train, prefill and
decode on a fake (2, 2) mesh (``repro_torch.launch.dryrun.lower_case``):
every info key of the reference's dry run, the argument bytes by kind,
collectives by kind, and no process group left after a case.
"""
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

FAMILIES = {"dense": "minitron-8b", "moe": "olmoe-1b-7b", "ssm": "mamba2-370m",
            "hybrid": "jamba-1.5-large-398b", "audio": "whisper-tiny",
            "vlm": "paligemma-3b"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_families_trace_on_a_fake_mesh(family, kind):
    cfg = reduced(get_arch(FAMILIES[family]))
    shape = ShapeConfig(f"small_{kind}", 64, 4, kind)
    _, cost, info = dryrun.lower_case(
        cfg, shape, False, mesh=AbstractMesh((2, 2), ("data", "model")))
    assert {"arch", "shape", "multi_pod", "unrolled", "model_parallel", "kind",
            "profile", "params_total", "params_active", "flops",
            "bytes_accessed", "memory", "collectives",
            "compile_seconds"} <= set(info)
    mem = info["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        mem["argument_bytes_by_kind"].values()) > 0
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert info["flops"] > 0 and info["bytes_accessed"] > 0
    coll = info["collectives"]
    assert coll["num_ops"] > 0 and coll["by_kind"]
    assert sum(k["count"] for k in coll["by_kind"].values()) == coll["num_ops"]
    assert cost.coll_bytes == coll["total_bytes"] > 0
    assert not torch.distributed.is_initialized()
