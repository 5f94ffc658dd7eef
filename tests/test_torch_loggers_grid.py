"""PyTorch port, the host-side utilities against the JAX package (CPU):
utils/loggers (the TensorBoard event file byte for byte, CSV, JSONL, the
refused backend), utils/image_grid (the frame grid, and the stdlib PNG
decoded by PIL against the JAX package's PNG) and the native preprocessing
loader (native/preproc.cpp built with g++ into tmp_path, against its plain
NumPy version and the JAX package's loader)."""

import json
import os
import socket
import time

import numpy as np
import pytest
from PIL import Image

from open_pandora_tpu import native as jnative
from open_pandora_tpu.utils import image_grid as jgrid
from open_pandora_tpu.utils import loggers as jlog
from open_pandora_tpu_torch import native
from open_pandora_tpu_torch.utils import image_grid as tgrid
from open_pandora_tpu_torch.utils import loggers as tlog

RECORDS = [(1, {"loss": 1.0, "grad_norm": 2.5, "lr": 1e-4}),
           (2, {"loss": 0.5, "grad_norm": 1.25, "lr": 1e-4}),
           (300, {"loss": 0.125, "grad_norm": 3.0, "sec_per_step": 0.75}),
           (2 ** 40, {"loss": -0.0, "grad_norm": float("inf"), "lr": 0.0})]


def _log(mod, root, backends):
    m = mod.MetricsLogger(str(root), backends=backends)
    for step, metrics in RECORDS:
        m.log(step, metrics)
    m.close()


# -- loggers --------------------------------------------------------------------------


def test_crc32c_check_value():
    """CRC-32C of "123456789" is 0xE3069283 (the standard check value)."""
    assert tlog.crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"a", bytes(range(256))):
        assert tlog.masked_crc(data) == jlog._masked_crc(data)


def test_tensorboard_file_equals_jax(tmp_path, monkeypatch):
    """With the clock and the host name fixed, both packages write the same
    file name and the same bytes."""
    monkeypatch.setattr(time, "time", lambda: 1790000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    _log(tlog, tmp_path / "ours", "tensorboard")
    _log(jlog, tmp_path / "ref", "tensorboard")
    ours, ref = tmp_path / "ours" / "tb", tmp_path / "ref" / "tb"
    assert os.listdir(ours) == os.listdir(ref) == [
        "events.out.tfevents.1790000000.host"]
    name = os.listdir(ours)[0]
    data = (ours / name).read_bytes()
    assert len(data) > 100 and data == (ref / name).read_bytes()


def test_csv_and_jsonl_equal_jax(tmp_path):
    """metrics.csv (the first record's keys, sorted; later keys dropped,
    missing ones empty) and metrics.jsonl, over two loggers appending to
    the same directory."""
    for _ in range(2):
        _log(tlog, tmp_path / "ours", "csv,none")
        _log(jlog, tmp_path / "ref", "csv,none")
    for name in ("metrics.csv", "metrics.jsonl"):
        assert (tmp_path / "ours" / name).read_bytes() == (
            tmp_path / "ref" / name).read_bytes()
    lines = (tmp_path / "ours" / "metrics.csv").read_text().splitlines()
    assert lines[0] == "step,grad_norm,loss,lr" and len(lines) == 9
    assert json.loads((tmp_path / "ours" / "metrics.jsonl").read_text()
                      .splitlines()[0]) == {"step": 1, **RECORDS[0][1]}
    assert not (tmp_path / "ours" / "tb").exists()


def test_unknown_backend_refused_as_jax(tmp_path):
    with pytest.raises(ValueError) as ours:
        tlog.MetricsLogger(str(tmp_path), backends="tensorboard,mlflow")
    with pytest.raises(ValueError) as ref:
        jlog.MetricsLogger(str(tmp_path), backends="tensorboard,mlflow")
    assert str(ours.value) == str(ref.value)
    assert "unknown logger backend 'mlflow'" in str(ours.value)


# -- image grid -----------------------------------------------------------------------


@pytest.mark.parametrize("t,dtype", [(16, np.float32), (4, np.float32),
                                     (20, np.uint8), (7, np.float64)])
def test_video_grid_equals_jax(t, dtype):
    rng = np.random.default_rng(51)
    v = (rng.integers(0, 256, (t, 6, 10, 3)) if dtype == np.uint8
         else rng.uniform(-1.3, 1.3, (t, 6, 10, 3))).astype(dtype)
    out = tgrid.video_grid(v)
    assert out.dtype == np.uint8
    assert np.array_equal(out, jgrid.video_grid(v))


@pytest.mark.parametrize("b,t", [(1, 16), (3, 8), (6, 5)])
def test_png_equals_jax_png(tmp_path, b, t):
    """The stdlib PNG, decoded by PIL, is pixel-equal to the JAX package's
    PIL-written PNG (and to the grid array): 8-bit RGB, at most 4 rows."""
    v = np.random.default_rng(52).uniform(-1, 1, (b, t, 6, 10, 3))
    ours = tgrid.save_sample_grid(str(tmp_path / "a" / "ours.png"), v)
    ref = jgrid.save_sample_grid(str(tmp_path / "ref.png"), v)
    with Image.open(ours) as a, Image.open(ref) as r:
        assert a.mode == r.mode == "RGB" and a.size == r.size
        assert np.array_equal(np.asarray(a), np.asarray(r))
        pixels = np.asarray(a)
    grid = np.concatenate([jgrid.video_grid(x) for x in v[:4]], axis=0)
    assert np.array_equal(pixels, grid)


def test_png_refuses_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="RGB"):
        tgrid.write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 4), np.uint8))


# -- native preprocessing ---------------------------------------------------------------


@pytest.mark.parametrize("src_hw,out_hw,scale,offset", [
    ((50, 80), (32, 48), (2.0,) * 3, (-1.0,) * 3),
    ((300, 200), (224, 224), (1 / 0.27,) * 3, (-0.48 / 0.27,) * 3),
    ((32, 32), (32, 32), (1.0,) * 3, (0.0,) * 3),
    ((20, 30), (64, 40), (1.0, 0.5, 2.0), (0.0, 0.1, -1.0)),
])
def test_native_matches_plain_and_jax(tmp_path, src_hw, out_hw, scale,
                                      offset):
    """Built with g++ into tmp_path: within 1e-5 of the plain NumPy version
    (the compiler may contract the bilinear sum into FMAs) and of the JAX
    package's loader on the same frames."""
    frames = np.random.default_rng(53).integers(0, 256, (3, *src_hw, 3),
                                                dtype=np.uint8)
    out = native.resize_center_crop_normalize(frames, out_hw, scale, offset,
                                              build_dir=tmp_path)
    assert out.shape == (3, *out_hw, 3) and out.dtype == np.float32
    plain = native.resize_center_crop_normalize_plain(frames, out_hw, scale,
                                                      offset)
    assert np.abs(out - plain).max() < 1e-5
    ref = jnative.resize_center_crop_normalize(frames, out_hw, scale, offset)
    assert np.abs(out - ref).max() < 1e-5
    assert native.library_path(tmp_path).exists()


def test_native_u8_to_pm1(tmp_path):
    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    out = native.u8_to_pm1(x, build_dir=tmp_path)
    assert np.abs(out - native.u8_to_pm1_plain(x)).max() < 1e-6
    assert np.abs(out - jnative.u8_to_pm1(x)).max() < 1e-6
    assert out[0, 0, 0] == -1.0 and abs(out[-1, -1, -1] - 1.0) < 1e-6


def test_native_build_failure_raises_with_compiler_message(tmp_path,
                                                           monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    message."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "build")
