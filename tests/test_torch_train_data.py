"""The port's training data (video_quierer_tpu_torch/train/data.py) against
the JAX package's: captions from file names and ``captions.json``, and
(frame, caption) batches decoded from synthetic videos (OpenCV, as both
packages' ingest decodes them), equal array for array and id for id."""

import json

import numpy as np
import pytest

from tests.helpers import make_synthetic_video
from video_quierer_tpu.models.clip.tokenizer import \
    HashTokenizer as JaxHashTokenizer
from video_quierer_tpu.ops.preprocess import SIGLIP_MEAN, SIGLIP_STD
from video_quierer_tpu.train import data as jax_data
from video_quierer_tpu_torch.ingest import frames
from video_quierer_tpu_torch.models.clip.tokenizer import HashTokenizer
from video_quierer_tpu_torch.train import data


@pytest.mark.parametrize("name,captions", [
    ("my_dog_at_the_beach.mp4", None),
    ("1c2ff5aa-1111-2222-3333-444455556666_holiday-trip.mp4", None),
    ("street.scene-at.night.mov", None),
    ("___.mp4", None),
    ("x.mp4", {"x.mp4": "a custom caption"}),
    ("y.mp4", {"x.mp4": "a custom caption"})])
def test_caption_for_matches_jax(name, captions):
    assert data.caption_for(name, captions) == \
        jax_data.caption_for(name, captions)


@pytest.mark.parametrize("content", [None, json.dumps({"a.mp4": "hello",
                                                       "b.mp4": 3}),
                                     "{broken", json.dumps(["a.mp4"])])
def test_load_captions_matches_jax(tmp_path, content):
    if content is not None:
        (tmp_path / "captions.json").write_text(content)
    assert data.load_captions(tmp_path) == jax_data.load_captions(tmp_path)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("train-videos")
    paths = [make_synthetic_video(d / name, n_frames=n, size=(64, 48))
             for name, n in (("a_red_car.mp4", 30), ("blue-sky.mp4", 45),
                             ("c.mp4", 24))]
    (d / "captions.json").write_text(json.dumps({"c.mp4": "a cat"}))
    return d, paths


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_frame_caption_batches_match_jax(videos, family):
    """Whole batches only (the ragged tail dropped), normalised with the
    family's mean and std, at the tower's frame size."""
    d, paths = videos
    kw = dict(batch_size=8, max_frames_per_video=12, image_size=32,
              captions=data.load_captions(d))
    if family == "siglip":
        kw.update(mean=SIGLIP_MEAN, std=SIGLIP_STD)
    want = list(jax_data.frame_caption_batches(paths, JaxHashTokenizer(),
                                               **kw))
    got = list(data.frame_caption_batches(paths, HashTokenizer(), **kw))
    assert len(got) == len(want) >= 2
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.dtype == np.float32 and gi.shape == (8, 32, 32, 3)
        assert gt.dtype == np.int32 and gt.shape == (8, 77)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_train_on_videos_matches_jax(videos):
    """The epoch loop hands the trainer the same batches, epoch after
    epoch, and returns its losses."""
    _, paths = videos

    class Recorder:
        def __init__(self):
            self.calls = []

        def step(self, images, ids):
            self.calls.append((images, ids))
            return float(len(self.calls))

    port, ref = Recorder(), Recorder()
    kw = dict(epochs=2, batch_size=8, max_frames_per_video=12,
              image_size=32)
    losses = data.train_on_videos(port, paths, HashTokenizer(), **kw)
    assert losses == jax_data.train_on_videos(ref, paths, JaxHashTokenizer(),
                                              **kw)
    assert len(port.calls) == len(ref.calls) > 2
    for (gi, gt), (wi, wt) in zip(port.calls, ref.calls):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_frames_are_decoded_through_extract_frames(videos, monkeypatch):
    """The decode looks ``ingest/frames.py:extract_frames`` up at call
    time (a machine without OpenCV feeds seeded frames this way)."""
    _, paths = videos
    seen = []

    def seeded(path, *, max_frames, sampling_mode, target_size):
        seen.append((path.name, max_frames, sampling_mode, target_size))
        img = np.full((5, target_size, target_size, 3), len(seen), np.uint8)
        return img, [0.1 * i for i in range(5)]

    monkeypatch.setattr(frames, "extract_frames", seeded)
    batches = list(data.frame_caption_batches(
        paths, HashTokenizer(), batch_size=4, max_frames_per_video=9,
        image_size=16))
    assert sorted(seen) == sorted((p.name, 9, "medium", 16) for p in paths)
    assert len(batches) == 3          # 15 frames: 3 whole batches of 4
    assert batches[0][0].shape == (4, 16, 16, 3)
