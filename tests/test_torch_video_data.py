"""PyTorch port, video files and real training data against the JAX package
(CPU): utils/video_io (write_video, read_video_frames, probe_video),
data/webvid (resize_center_crop, WebVidDataset with its stdlib CSV reader,
PrefetchLoader's batches of its samples), the video records of data/sft,
and the trainer on WebVid clips from --meta-path. The clips are written by
OpenCV into tmp_path from NumPy seeds; the readers depend only on OpenCV
and NumPy, so the two packages' outputs are held bit-equal."""

import json
import os

import numpy as np
import pytest
import torch

from open_pandora_tpu.data import sft as jsft
from open_pandora_tpu.data import webvid as jweb
from open_pandora_tpu.pipeline import preprocess as jpre
from open_pandora_tpu.pipeline.tokenizers import HashFallbackTokenizer as JTok
from open_pandora_tpu.utils import video_io as jvio
from open_pandora_tpu_torch.data import sft as tsft
from open_pandora_tpu_torch.data import webvid as tweb
from open_pandora_tpu_torch.pipeline import preprocess as tpre
from open_pandora_tpu_torch.pipeline.tokenizers import (
    HashFallbackTokenizer as TTok)
from open_pandora_tpu_torch.train import trainer
from open_pandora_tpu_torch.utils import video_io as tvio


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread keeps their ops from
    competing for the cores with the suite's other workers, where eight
    spinning threads each slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seed: int, frames: int, h: int = 48, w: int = 64) -> np.ndarray:
    """A smooth moving gradient (lossy codecs destroy pure noise) with a
    seeded tint: uint8 (frames, h, w, 3)."""
    tint = np.random.default_rng(seed).integers(0, 200)
    g = np.linspace(0, 255, max(h, w)).astype(np.uint8)
    frame = np.stack(np.broadcast_arrays(g[:h, None], g[None, :w],
                                         np.uint8(tint)), -1).astype(np.uint8)
    return np.stack([np.roll(frame, 2 * j, axis=1) for j in range(frames)])


# -- utils/video_io --------------------------------------------------------------


def test_write_read_roundtrip(tmp_path):
    """mp4 out and back: shape, fps, and a mean error under 16 levels (a
    lossy codec)."""
    frames = _clip(1, 8, 64, 64)
    path = tvio.write_video(str(tmp_path / "sub" / "a.mp4"), frames, fps=8)
    back, fps = tvio.read_video_frames(path)
    assert back.shape == (8, 64, 64, 3) and back.dtype == np.uint8
    assert abs(fps - 8) < 0.5
    assert np.abs(back.astype(int) - frames.astype(int)).mean() < 16
    assert tvio.probe_video(path) == (8, fps)


def test_uniform_sampling_and_missing_indices(tmp_path):
    frames = np.stack([np.full((32, 32, 3), i * 10, np.uint8)
                       for i in range(20)])
    path = tvio.write_video(str(tmp_path / "ramp.mp4"), frames, fps=10)
    out, _ = tvio.read_video_frames(path, num_frames=4)
    means = out.reshape(4, -1).mean(1)
    assert out.shape[0] == 4 and means[0] < means[-1]
    # an index past the end takes the last decoded frame
    tail, _ = tvio.read_video_frames(path, indices=[19, 25])
    assert np.array_equal(tail[0], tail[1])
    with pytest.raises(IOError):
        tvio.probe_video(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("kw", [{}, {"num_frames": 5},
                                {"indices": [0, 3, 3, 9, 40]}])
def test_read_video_frames_equals_jax(tmp_path, kw):
    path = jvio.write_video(str(tmp_path / "c.mp4"), _clip(2, 12), fps=12)
    out, fps = tvio.read_video_frames(path, **kw)
    ref, jfps = jvio.read_video_frames(path, **kw)
    assert fps == jfps and np.array_equal(out, ref)


# -- data/webvid ------------------------------------------------------------------


@pytest.mark.parametrize("src_hw,out_hw", [((30, 60), (32, 32)),
                                           ((90, 160), (32, 48)),
                                           ((48, 64), (48, 64))])
def test_resize_center_crop_equals_jax(src_hw, out_hw):
    """Upscale (bilinear), downscale (area) and identity: bit-equal."""
    frames = np.random.default_rng(3).integers(0, 256, (2, *src_hw, 3),
                                               dtype=np.uint8)
    out = tweb.resize_center_crop(frames, *out_hw)
    assert out.shape == (2, *out_hw, 3)
    assert np.array_equal(out, jweb.resize_center_crop(frames, *out_hw))


def _corpus(root, broken=(), short=(), fps=8, frames=24):
    """Clips 0..5 under videos/p<i % 2>/ (a broken file or a short clip
    where asked); the metadata holds a caption with a quoted comma, a row
    whose caption is "NA" (pandas reads it as missing, so it is dropped)
    and a row with an empty page_dir (dropped too)."""
    rows = ['videoid,page_dir,name']
    for i in range(6):
        d = os.path.join(root, "videos", f"p{i % 2}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"v{i}.mp4")
        if i in broken:
            with open(path, "wb") as f:
                f.write(b"not a video")
        else:
            jvio.write_video(path, _clip(10 + i, 5 if i in short else frames),
                             fps=fps)
        rows.append(f'v{i},p{i % 2},"caption {i}, with a comma"')
    rows += ["v9,p1,NA", "v8,,orphan", ""]
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w") as f:
        f.write("\n".join(rows))
    return meta


def _samples_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("kw", [
    dict(frame_stride=2),
    dict(frame_stride=5, random_fs=True, frame_stride_min=2),
    dict(frame_stride=1, fixed_fps=4, fps_max=3),
    dict(frame_stride=3, rand_cond_frame=False, subsample=7),
])
def test_webvid_dataset_equals_jax(tmp_path, kw):
    """The same seed gives the same samples in both packages, in order:
    video, conditioning frame, CLIP image, caption, fps and stride, over
    two passes through the rows (the rng is consumed across calls). Clip
    1 is broken and clip 4 too short: both are skipped to the next row."""
    meta = _corpus(str(tmp_path), broken=(1,), short=(4,))
    args = (meta, str(tmp_path))
    opts = dict(video_length=4, resolution=(32, 40), seed=7, **kw)
    ours, ref = tweb.WebVidDataset(*args, **opts), jweb.WebVidDataset(*args,
                                                                     **opts)
    # 6 valid rows of 8; pandas' draw of 7 rows (subsample) keeps 5 of them
    n = len(ref)
    assert len(ours) == n and n == (5 if "subsample" in kw else 6)
    assert [r["caption"] for r in ours.metadata] == list(
        ref.metadata["caption"])
    for i in list(range(n)) * 2:
        _samples_equal(ours[i], ref[i])
    s = ours[0]
    assert s["video"].shape == (4, 32, 40, 3)
    assert s["cond_image"].shape == (224, 224, 3)
    assert s["caption"].endswith(", with a comma")


def test_metadata_reader_matches_pandas(tmp_path):
    meta = _corpus(str(tmp_path))
    import pandas as pd
    frame = pd.read_csv(meta, dtype=str)
    rows = tweb.read_metadata(meta)
    assert len(rows) == len(frame) == 8
    for r, (_, p) in zip(rows, frame.iterrows()):
        assert r == {k: None if pd.isna(v) else v for k, v in p.items()}


def test_prefetch_loader_collates_webvid_as_jax(tmp_path):
    """One epoch of one batch of all 6 rows (5 readable): the port's
    PrefetchLoader and the JAX one (one worker, unsharded) give equal
    arrays, captions tokenized to 77."""
    meta = _corpus(str(tmp_path), broken=(1,))
    opts = dict(video_length=4, resolution=(32, 40), seed=3)
    ours = tweb.PrefetchLoader(
        tweb.WebVidDataset(meta, str(tmp_path), **opts), 6)
    ref = jweb.PrefetchLoader(
        jweb.WebVidDataset(meta, str(tmp_path), **opts), 6, num_workers=1,
        shard=False)
    (a,), (b,) = list(ours.epoch(0)), list(ref.epoch(0))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["video"].shape == (6, 4, 32, 40, 3)


def test_trainer_steps_on_webvid(tmp_path):
    """`--tiny --device cpu` from --meta-path: the clips come from
    WebVidDataset at the config file's frame_stride and fixed_fps (both
    once refused; configs/finetune_1024.yaml sets them so), two steps with
    finite losses."""
    meta = _corpus(str(tmp_path / "data"), fps=16)
    config = tmp_path / "webvid.yaml"
    config.write_text("train:\n  frame_stride: 2\n  fixed_fps: 8\n")
    seen = []
    real = tweb.WebVidDataset.__getitem__

    def spy(self, i):
        seen.append((self.frame_stride, self.fixed_fps))
        return real(self, i)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tweb.WebVidDataset, "__getitem__", spy)
        trainer.run(["--tiny", "--device", "cpu", "--meta-path", meta,
                     "--data-dir", str(tmp_path / "data"), "--max-steps",
                     "2", "--logdir", str(tmp_path / "runs"), "--name", "w",
                     "--config", str(config), "--set",
                     "train.stage=dynamicrafter", "--set",
                     "train.log_every=1", "--logger", "csv"])
    assert seen and set(seen) == {(2, 8)}
    with open(tmp_path / "runs" / "w" / "loginfo" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


# -- data/sft video records --------------------------------------------------------


def test_sft_video_record_equals_jax(tmp_path, monkeypatch):
    """A <video> record read from an mp4 (6 frames sampled uniformly from
    10) lowers to the JAX package's example: ids, labels, layout, and the
    tower images, the JAX side's PIL preprocessing replaced by the port's
    (test_torch_chat_wm.py holds the two to each other)."""
    jvio.write_video(str(tmp_path / "clip.mp4"), _clip(5, 10), fps=8)
    chat = tmp_path / "chat.json"
    chat.write_text(json.dumps([
        {"video": "clip.mp4", "conversations": [
            {"from": "human", "value": "<video>\nwhat happens next?"},
            {"from": "gpt", "value": "the car turns left"}]},
        {"video": "missing.mp4", "conversations": [
            {"from": "human", "value": "<video>\nand here?"},
            {"from": "gpt", "value": "nothing"}]}]))
    monkeypatch.setattr(jpre, "clip_tower_preprocess",
                        lambda img, size: tpre.clip_tower_preprocess(
                            np.asarray(img), size).numpy())
    kw = dict(video_root=str(tmp_path), clip_size=56, max_frames=6, seed=0)
    ours = tsft.ConversationDataset([str(chat)], TTok(), **kw)
    ref = jsft.ConversationDataset([str(chat)], JTok(), **kw)
    i = next(j for j, r in enumerate(ours.records)
             if r["video"] == "clip.mp4")
    te, je = ours[i], ref[i]
    assert (te.chunk_ids, te.chunk_labels, te.n_images, te.is_video) == (
        je.chunk_ids, je.chunk_labels, je.n_images, je.is_video)
    assert te.is_video and te.images.shape == (6, 56, 56, 3)
    assert np.array_equal(te.images, je.images)
    # the unreadable record is skipped by the batcher, as in JAX
    from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config
    batches = list(ours.batches(1, debug_world_config()))
    assert len(batches) == 1
    assert torch.is_tensor(batches[0]["labels"])
