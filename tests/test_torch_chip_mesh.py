"""``chip_smoke.py``'s phase 19 (the mesh) on the CPU at the smoke
widths (the full configs are for the card): (a) the dry runs of one
production cell and of the d-HNSW variants against the committed
reference, (b) the meshed train step bit for bit against the unmeshed
one, (c) the meshed serve steps' tokens, (d) ``_moe_shardmap`` over 4
gloo ranks on two meshes, a second seed and in f32 against the plain
version, (e) the d-HNSW step
over 4 gloo ranks (its store cut to 8 partitions) against one rank, (f)
every family's meshed serve steps over 4 and 8 gloo ranks against the
unmeshed path, (g) the meshed train step sequence parallel over 4 gloo
ranks against the unmeshed step."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from lm_parity import one_thread  # noqa: E402,F401
from repro_torch.configs.registry import smoke_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_mesh_phase_on_cpu(monkeypatch, capsys, one_thread):
    """One torch thread here as in the rank processes: the plain moe's
    router product then rounds as theirs does (near-tied experts)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the rank processes
    monkeypatch.setattr(cs, "get_config", smoke_config)
    monkeypatch.setattr(cs, "MESH_SMOKE", True)
    monkeypatch.setattr(cs, "MESH_ARCHS", ("qwen3-8b",))
    monkeypatch.setattr(cs, "MESH_SHAPES", ("decode_32k",))
    monkeypatch.setattr(cs, "TRAIN", dict(n_layers=2, seq=64, batch=4,
                                          micro_steps=2, steps=1))
    monkeypatch.setattr(cs, "MESH_SERVE", dict(batch=2, seq=32, steps=3))
    monkeypatch.setattr(cs, "MESH_MOE", dict(batch=4, seq=16, iters=1,
                                             runs=cs.MESH_MOE["runs"]))
    monkeypatch.setattr(cs, "MESH_DHNSW", dict(world=4, iters=1))
    for name in ("N_PARTS", "N_BLOCKS"):            # dhnsw_small's cut
        monkeypatch.setattr(cs.dryrun_dhnsw, name,
                            getattr(cs.dryrun_dhnsw, name))
    da = cs.phase_mesh(torch.device("cpu"), "cpu", step_17a=1.0)
    out = capsys.readouterr().out
    assert da == 0                   # the plain decode on CPU tensors
    assert out.count("[19a dry run] qwen3-8b|decode_32k|") == 2
    assert out.count("[19a dry run] dhnsw-serve/") == 12
    assert "bit for bit" in out and "[19b mesh train]" in out
    assert "tokens equal to the unmeshed" in out
    assert out.count("[19d moe shardmap]") == 4
    assert out.count("[19e d-HNSW step]") == 6
    assert out.count("[19f mesh ") == len(cs.MESH_FAMILIES)
    assert out.count("[19g mesh sp]") == 1
