"""PyTorch port, `--ckpt` in every dialect the JAX package reads (CPU): a
tiny WorldModel's state dict saved as two `.safetensors` shards, two
`.bin` shards, one `.safetensors` file, a PL file and a trainer `step_<n>`
directory loads through pipeline/cli.load_weights to the same tensors;
core.checkpoint.load_torch_flat gives the JAX load_torch_flat's keys and
values on the same files; the port's own safetensors reader against the
safetensors package; normalize_state_dict against the JAX one."""

import argparse

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from open_pandora_tpu.core import checkpoint as jckpt
from open_pandora_tpu.core.convert import \
    normalize_state_dict as jax_normalize
from open_pandora_tpu_torch.core.checkpoint import (load_torch_flat,
                                                    read_safetensors,
                                                    save_params)
from open_pandora_tpu_torch.core.convert import normalize_state_dict
from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                     debug_world_config)
from open_pandora_tpu_torch.pipeline.cli import load_weights


@pytest.fixture(scope="module")
def world_sd():
    wm = build_world_model(debug_world_config(), device="cpu",
                           generator=torch.Generator().manual_seed(71))
    return {k: v.detach().clone().contiguous()
            for k, v in wm.state_dict().items()}


def _halves(sd):
    keys = list(sd)
    return ({k: sd[k] for k in keys[: len(keys) // 2]},
            {k: sd[k] for k in keys[len(keys) // 2:]})


def _write(kind, sd, tmp_path):
    a, b = _halves(sd)
    if kind == "safetensors_shards":
        d = tmp_path / "hf_st"
        d.mkdir()
        save_file(a, str(d / "model-00001-of-00002.safetensors"))
        save_file(b, str(d / "model-00002-of-00002.safetensors"))
        (d / "config.json").write_text("{}")
        return str(d)
    if kind == "bin_shards":
        d = tmp_path / "hf_bin"
        d.mkdir()
        torch.save(a, d / "pytorch_model-00001-of-00002.bin")
        torch.save(b, d / "pytorch_model-00002-of-00002.bin")
        # HF Trainer keeps its pickled arguments beside the shards
        torch.save(argparse.Namespace(learning_rate=1e-4),
                   d / "training_args.bin")
        return str(d)
    if kind == "safetensors_file":
        save_file(sd, str(tmp_path / "model.safetensors"))
        return str(tmp_path / "model.safetensors")
    torch.save({"state_dict": {f"_forward_module.{k}": v
                               for k, v in sd.items()}},
               tmp_path / "model.ckpt")
    return str(tmp_path / "model.ckpt")


KINDS = ["safetensors_shards", "bin_shards", "safetensors_file", "pl_file"]


@pytest.mark.parametrize("kind", KINDS)
def test_load_weights_reads_every_dialect(kind, world_sd, tmp_path):
    """Each layout loads through --ckpt's loader to the saved tensors, into
    a model whose storage was never initialised."""
    path = _write(kind, world_sd, tmp_path)
    wm = build_world_model(debug_world_config(), device="cpu")
    load_weights(wm, path)
    got = wm.state_dict()
    assert got.keys() == world_sd.keys()
    for k, v in world_sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", KINDS)
def test_load_torch_flat_matches_jax(kind, world_sd, tmp_path):
    path = _write(kind, world_sd, tmp_path)
    ours = load_torch_flat(path)
    ref = jckpt.load_torch_flat(path)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_step_dir_restores_over_the_model(world_sd, tmp_path):
    """A trainer step_<n> directory (its params.pt) is restored, not read
    as a shard directory: its parameters over the model's, the rest kept."""
    unet = {k: v for k, v in world_sd.items() if ".diffusion_model." in k}
    path = save_params(str(tmp_path / "ckpts"), unet, step=5)
    wm = build_world_model(debug_world_config(), device="cpu",
                           generator=torch.Generator().manual_seed(72))
    before = {k: v.clone() for k, v in wm.state_dict().items()}
    load_weights(wm, path)
    got = wm.state_dict()
    for k, v in got.items():
        assert torch.equal(v, unet[k] if k in unet else before[k]), k


def test_missing_key_raises(world_sd, tmp_path):
    sd = dict(world_sd)
    sd.pop(next(k for k in sd if k.endswith(".weight")))
    save_file(sd, str(tmp_path / "part.safetensors"))
    wm = build_world_model(debug_world_config(), device="cpu")
    with pytest.raises(KeyError, match="keys missing"):
        load_weights(wm, str(tmp_path / "part.safetensors"))


def test_safetensors_reader_matches_package(tmp_path):
    """Every dtype the reader takes, a scalar, an empty tensor and a
    header with __metadata__, against safetensors.torch.load_file."""
    g = torch.Generator().manual_seed(73)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, 2, generator=g).half(),
        "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }
    tensors["f64"] = torch.randn(2, 2, generator=g, dtype=torch.float64)
    tensors["bool"] = torch.randn(5, generator=g) > 0
    for dt in (torch.int8, torch.uint8, torch.int16, torch.uint16,
               torch.int32, torch.uint32, torch.int64, torch.uint64):
        tensors[str(dt)] = torch.randint(0, 100, (7,), generator=g,
                                         dtype=dt)
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ours, ref = read_safetensors(path), load_file(path)
    assert ours.keys() == ref.keys() == tensors.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_safetensors_reader_refuses_other_dtypes(dtype, tmp_path):
    path = str(tmp_path / "t.safetensors")
    save_file({"x": torch.ones(3).to(dtype)}, path)
    with pytest.raises(ValueError, match="has dtype"):
        read_safetensors(path)


def test_directory_without_weights_names_its_files(tmp_path):
    """A directory whose torch files hold no weights is refused, naming
    them; one such file beside shards is skipped (bin_shards above)."""
    torch.save(argparse.Namespace(learning_rate=1e-4),
               tmp_path / "training_args.bin")
    torch.save([torch.ones(2)], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="training_args.bin"):
        load_torch_flat(str(tmp_path))


def test_normalize_state_dict_matches_jax():
    for raw in (
        {"state_dict": {"_forward_module.a.framestride_embed.w": 1,
                        "b": 2}},
        {"module": {"_forward_module.c": 3, "d.framestride_embed": 4}},
        {"state_dict": {"module": {"e": 5}}},
        {"x": 6, "_forward_module.y": 7},
    ):
        assert normalize_state_dict(raw) == jax_normalize(raw)
