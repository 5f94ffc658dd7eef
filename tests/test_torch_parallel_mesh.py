"""The port's parallel layer without a process group: build_mesh's
ValueErrors and ZeRO-2 / FSDP partition picks against the JAX package's on
the same shapes, process_shard_indices, init_distributed in a single
process and on a group that cannot form, the sequence-parallel context,
and the loaders' rank slices against the single-process batches."""

import datetime
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from open_pandora_tpu.core.config import MeshConfig as JaxMeshConfig
from open_pandora_tpu.parallel import mesh as jmesh
from open_pandora_tpu_torch.core.config import MeshConfig
from open_pandora_tpu_torch.data.webvid import (PrefetchLoader,
                                                SyntheticVideoDataset)
from open_pandora_tpu_torch.parallel import mesh as tmesh
from open_pandora_tpu_torch.parallel.launch import init_distributed
from open_pandora_tpu_torch.parallel.sp import current_sp, sp_eligible
from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config
import torch_parallel_workers as W


def _spec_of(cfg_n):
    """A MeshSpec whose data axis has `cfg_n` ranks (no group)."""
    sizes = {"data": cfg_n, "model": 1}
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: list(sizes.values())[i])
    return tmesh.MeshSpec(mesh=fake)


@pytest.mark.parametrize("dp,mp,n", [(3, 2, 8), (-1, 3, 8), (4, 1, 2)])
def test_build_mesh_rejects_what_jax_rejects(cpu_devices, dp, mp, n):
    cfg = dict(data_parallel=dp, model_parallel=mp)
    with pytest.raises(ValueError) as jerr:
        jmesh.build_mesh(JaxMeshConfig(**cfg), devices=cpu_devices[:n])
    with pytest.raises(ValueError) as terr:
        tmesh.build_mesh(MeshConfig(**cfg), world_size=n)
    assert str(terr.value) == str(jerr.value)


def test_build_mesh_single_process():
    ms = tmesh.build_mesh(MeshConfig())
    assert ms.mesh is None and ms.n_data == ms.n_model == 1
    assert ms.data_rank == 0 and ms.data_group is None
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.build_mesh(MeshConfig(), world_size=2)


# shapes that take every branch of _shardable_axis at 8 ranks: the larger
# divisible axis, the first of equal ones, none divisible, too small
SHAPES = {"w": (1024, 256), "v": (24, 4096), "eq": (512, 512),
          "odd": (1023, 129), "b": (8,), "emb": (49408, 64),
          "conv": (320, 320, 3, 3)}


def _axis(spec: P):
    names = [i for i, s in enumerate(spec) if s is not None]
    return names[0] if names else None


@pytest.mark.parametrize("min_size", [2 ** 16, 1024])
def test_partition_picks_match_jax(mesh8, min_size):
    """zero2_opt_spec and fsdp_param_spec pick, per leaf, the axis JAX's
    sharding specs split over the data axis (None = replicated)."""
    tree = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    ms = _spec_of(8)
    for jfn, tfn in ((jmesh.zero2_opt_spec, tmesh.zero2_opt_spec),
                     (jmesh.fsdp_param_spec, tmesh.fsdp_param_spec)):
        want = {k: _axis(s.spec) for k, s in jfn(mesh8, tree,
                                                 min_size=min_size).items()}
        assert tfn(ms, SHAPES, min_size=min_size) == want
    picks = tmesh.zero2_opt_spec(ms, SHAPES)
    assert picks["w"] == 0 and picks["v"] == 1 and picks["eq"] == 0
    assert picks["odd"] is None and picks["b"] is None


def test_process_shard_indices_single_process():
    assert tmesh.process_shard_indices(5) == range(0, 5)


def test_shard_rows_rejects_an_indivisible_batch():
    assert tmesh.shard_rows(np.arange(6), 3, 1).tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_rows(np.arange(5), 2, 0)


def test_init_distributed_is_a_no_op_alone(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_raises_when_the_group_cannot_form(monkeypatch):
    """The environment names 2 processes and only this one comes: the
    rendezvous times out and raises (the JAX package would stay
    single-host)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(W.free_port()))
    with pytest.raises(torch.distributed.DistError):
        init_distributed("cpu", timeout=datetime.timedelta(seconds=1))
    assert not torch.distributed.is_initialized()


def test_sp_context_does_not_leak():
    """Outside sequence_parallel, attention never takes the ring."""
    assert current_sp() is None
    assert not sp_eligible((1, 64, 2, 16), (1, 64, 2, 16), True, None)


def test_video_loader_rank_slices(monkeypatch):
    """Each of 2 ranks loads only its rows of every global batch of 4, and
    the ranks' rows together are the single-process batches."""
    ds = SyntheticVideoDataset(video_length=4, resolution=(8, 8),
                               clip_size=8)
    whole = list(PrefetchLoader(ds, 4).epoch(1))
    loaded = []
    real = SyntheticVideoDataset.__getitem__
    monkeypatch.setattr(SyntheticVideoDataset, "__getitem__",
                        lambda self, i: loaded.append(i) or real(self, i))
    parts = [list(PrefetchLoader(ds, 4, shard=(r, 2)).epoch(1))
             for r in range(2)]
    assert len(loaded) == len(ds) - len(ds) % 4
    assert len(parts[0]) == len(parts[1]) == len(whole)
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            joined = np.concatenate([parts[0][i][k], parts[1][i][k]])
            assert np.array_equal(joined, v), k
    with pytest.raises(ValueError, match="not divisible"):
        PrefetchLoader(ds, 3, shard=(0, 2))


def test_sft_batches_rank_slices():
    """The SFT loader's rank slices are rows of the single-process global
    batch (its lengths); sharding needs drop_remainder."""
    from open_pandora_tpu_torch.data.sft import ConversationDataset
    cfg = debug_world_config()
    whole = W.sft_batch(cfg)
    parts = [W.sft_batch(cfg, (r, 2)) for r in range(2)]
    assert torch.equal(torch.cat([p["labels"] for p in parts]),
                       whole["labels"])
    for i, seg in enumerate(whole["prompt"].segments):
        if hasattr(seg, "ids"):
            joined = torch.cat([p["prompt"].segments[i].ids for p in parts])
            assert torch.equal(joined, seg.ids)
    ds = ConversationDataset([], None, records=[])
    with pytest.raises(ValueError, match="drop_remainder"):
        next(iter(ds.batches(2, cfg, shard=(0, 2))))


def test_parallel_layer_imports_without_jax():
    """The parallel modules, the trainer and chip_smoke import in a process
    where `jax` and `open_pandora_tpu` cannot be imported."""
    import os
    import subprocess
    import sys

    mods = ["parallel.launch", "parallel.mesh", "parallel.sharded_infer",
            "parallel.tp", "parallel.sp", "train.trainer", "eval.inference"]
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['open_pandora_tpu'] = None; "
            + "; ".join(f"import open_pandora_tpu_torch.{m}" for m in mods)
            + "; import chip_smoke; "
            "assert not [m for m in sys.modules if sys.modules[m] is not None"
            " and m.split('.')[0] in ('jax', 'open_pandora_tpu')]")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=120)
