"""The port's streaming detector (slice 12) against the JAX package, on the
CPU: the stream of every YOLOv3T and YOLOv3Temporal configuration the port
builds against JAX's windowed apply and `postprocess` at every step, the
center anchor against JAX's clamped windows, one stream against JAX's own
`StreamingDetector` and `stream_frames`, the variable split and the split
each configuration takes, the feed models' parameters, the cases that
raise, the detect twin's `--stream` on two directories of JPEGs, and VID
whole videos.

Inputs are numpy frames from a seed at 64 px, float32, three classes;
weights are random flax variables in the shapes `jax.eval_shape(model.init)`
gives, drawn as tests/test_torch_temporal.random_variables draws them,
carried across by the flax bridge.  Detections are held within rtol=atol=1e-4 (float32 on both
sides, other summation orders and conv algorithms): the scores value by
value, each row (id, score, box) against the row's own magnitude, since a
box's corner is its centre less half its size and a corner near 0 of a box
hundreds of pixels wide (the random weights' boxes reach 800 px at 64 px)
carries the rounding of both; rows are matched in score order, and two rows
whose scores agree within the tolerance may come in either order.  On the CPU
the port takes the plain NMS and the plain correlation; the card's kernels
are held by chip_smoke.py's phase 16."""
import contextlib
import functools
import os
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental.compilation_cache.compilation_cache import reset_cache
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_vid import _vid, write_vid_tree
from videoyolo_tpu import streaming as jstreaming
from videoyolo_tpu.data.imgnetvid import ImageNetVidDetection as JaxVID
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_torch import detect, native, streaming
from videoyolo_torch.data.imgnetvid import ImageNetVidDetection
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from videoyolo_torch.serving import Detector, collect_boxes
from videoyolo_torch.streaming import StreamingDetector, split_temporal_variables, stream_frames
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)
from torch_heap import trim_heap

torch.set_num_threads(2)

S = 64
TOL = dict(rtol=1e-4, atol=1e-4)
YOLOV3T = {
    "late-max": dict(k=3, k_join_type="max", k_join_pos="late"),
    "early-cat": dict(k=3, k_join_type="cat", k_join_pos="early"),
    "corr-late": dict(k=3, corr_pos="late", corr_d=2),
    "slice2": dict(k=3, k_join_type="max", k_join_pos="late", corr_pos="early", corr_d=4),
}
T5 = {
    "t5-corr-pyramid": dict(t=5, t_out=True, corr_d=2),
    "t5-plain-tout": dict(t=5, t_out=True, corr_d=0),
    "t5-funnel": dict(t=5, t_out=False, corr_d=0),
}
# the split each configuration takes (the JAX package's too, test_split_choice_matches_jax)
SPLITS = {"late-max": "tips", "early-cat": "routes", "corr-late": "routes", "slice2": "routes",
          "t5-corr-pyramid": "stage1", "t5-plain-tout": "routes", "t5-funnel": "stage1"}


def _classes(name):
    return (JaxYOLOv3T, YOLOv3T) if name in YOLOV3T else (JaxYOLOv3Temporal, YOLOv3Temporal)


def _kw(name):
    return {**YOLOV3T, **T5}[name]


def _k(name):
    return _kw(name).get("k") or _kw(name)["t"]


def _frames(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, S, S, 3).astype(np.float32) for _ in range(n)]


def _window(frames, idx):
    return np.stack([frames[j] for j in idx], axis=1)


def _trail(i, k):
    """The window ending at frame i, left-padded with frame 0."""
    return [max(0, j) for j in range(i - k + 1, i + 1)]


@functools.lru_cache(maxsize=None)
def _shapes(name, feed=None):
    """The variables' shapes of JAX's model (or its feed clone)."""
    jm = _classes(name)[0](num_classes=3, feed=feed, **_kw(name))
    return jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), _input(name, feed))


def _input(name, feed=None):
    """A zero input of JAX's model: frames, or the feed's tip, route or
    stage-1 windows."""
    k = _k(name)
    if feed == "stage1":
        return jnp.zeros((1, k, S // 8, S // 8, 256), jnp.float32)
    levels = {"routes": ((8, 256), (16, 512), (32, 1024)), "tips": ((32, 1024), (16, 512), (8, 256))}.get(feed)
    if levels:
        return tuple(jnp.zeros((1, k, S // s, S // s, c), jnp.float32) for s, c in levels)
    return jnp.zeros((1, k, S, S, 3), jnp.float32)


def _variables(name, seed):
    """Random variables in `_shapes(name)`, as tests/test_torch_temporal.
    random_variables draws them (kernels N(0, 1/fan_in), BN scale and
    variance in [0.5, 1.5], the rest N(0, 0.01)), from numpy's Generator."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape, np.float32) * np.float32(0.1)

    return jax.tree_util.tree_map_with_path(fill, _shapes(name))


def _bridged_keys(tree):
    """The state_dict keys the bridge gives a variables (or shapes) tree."""
    return set(flax_to_state_dict(jax.tree_util.tree_map(lambda s: np.zeros((1,) * len(s.shape)), tree)))


def _models(name, seed=0):
    """(JAX model, its variables, the port's model on them in eval mode)."""
    jcls, tcls = _classes(name)
    variables = _variables(name, seed)
    tm = tcls(num_classes=3, **_kw(name))
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jcls(num_classes=3, **_kw(name)), variables, tm.eval()


@functools.lru_cache(maxsize=None)
def _jax_windowed(name):
    """JAX's apply and postprocess_tout, jitted once a configuration."""
    jm = _classes(name)[0](num_classes=3, **_kw(name))
    return jax.jit(lambda v, x: jax_postprocess_tout(*jm.apply(v, x, train=False)))


def assert_head_close(got, want):
    """A head's (boxes, scores) within TOL: each box against its own largest
    coordinate (see the module's docstring), the scores value by value."""
    (boxes, scores), (rboxes, rscores) = ((np.asarray(a, np.float64) for a in pair) for pair in (got, want))
    err = np.abs(boxes - rboxes).max(-1)
    assert (err <= TOL["atol"] + TOL["rtol"] * np.abs(rboxes).max(-1)).all(), f"boxes off by up to {err.max()}"
    np.testing.assert_allclose(scores, rscores, **TOL)


def rows_close(row, ref) -> bool:
    """A detection row (id, score, x1, y1, x2, y2) within TOL of `ref`,
    relative to the row's largest magnitude."""
    return bool(np.abs(row - ref).max() <= TOL["atol"] + TOL["rtol"] * np.abs(ref).max())


def assert_dets_close(got, want):
    """(ids, scores, boxes) within TOL: scores in order (both score-sorted),
    rows matched one to one by `rows_close`, so that rows of scores within
    TOL of each other may come in either order."""
    ids, sc, bb = (np.asarray(a, np.float64) for a in got)
    rids, rsc, rbb = (np.asarray(a, np.float64) for a in want)
    assert ids.shape == rids.shape and bb.shape == rbb.shape
    np.testing.assert_allclose(sc, rsc, **TOL)
    rows = np.concatenate([ids, sc, bb], -1).reshape(-1, ids.shape[-2], 6)
    ref = np.concatenate([rids, rsc, rbb], -1).reshape(-1, ids.shape[-2], 6)
    for img, (ours, theirs) in enumerate(zip(rows, ref)):
        unused = list(range(len(theirs)))
        for r, row in enumerate(ours):
            hit = next((u for u in unused if rows_close(row, theirs[u])), None)
            assert hit is not None, f"image {img} row {r} {row} has no match in the reference"
            unused.remove(hit)


def _check_stream_matches_windows(name, seed):
    _, variables, tm = _models(name, seed)
    k = _k(name)
    frames = _frames(k + 1, seed)
    stream = StreamingDetector(tm)
    assert stream.split == SPLITS[name] and stream.k == k
    dets = [stream.reset(torch.from_numpy(frames[0]))] + [stream.step(torch.from_numpy(f)) for f in frames[1:]]
    apply = _jax_windowed(name)
    for i, got in enumerate(dets):
        assert_dets_close(got, apply(variables, jnp.asarray(_window(frames, _trail(i, k)))))


@pytest.mark.parametrize("name", sorted(YOLOV3T))
def test_stream_equals_windowed(name):
    """reset and k steps of the port's stream against JAX's apply and
    postprocess on each window (left-padded with frame 0): the tip split
    (late-max) and the route split (early join, late correlation, slice 2's
    late join with early correlation)."""
    _check_stream_matches_windows(name, seed=1)


@pytest.mark.parametrize("name", sorted(T5))
def test_stream_t5_equals_windowed(name):
    """The same for YOLOv3Temporal t=5: the stage-1 split of the correlation
    pyramid and the funnel, the route split of the plain t_out path; t_out
    detections (1, 5, 100, .)."""
    _check_stream_matches_windows(name, seed=2)


def test_stream_center_matches_jax_windows():
    """anchor="center": exactly len(frames) pairs, in order, each equal to
    JAX's detections on the window centred on its frame, clamped at the
    clip's ends."""
    _, variables, tm = _models("slice2", seed=3)
    frames = _frames(6, seed=3)
    apply = _jax_windowed("slice2")
    got = list(stream_frames(StreamingDetector(tm), (torch.from_numpy(f) for f in frames), anchor="center"))
    assert [m for m, _ in got] == list(range(len(frames)))
    for m, dets in got:
        idx = [min(max(0, m + d), len(frames) - 1) for d in (-1, 0, 1)]
        assert_dets_close(dets, apply(variables, jnp.asarray(_window(frames, idx))))


@contextlib.contextmanager
def _no_compilation_cache():
    """JAX's persistent compilation cache off inside, as it was after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        reset_cache()


def test_stream_matches_jax_streaming_detector():
    """One stream against JAX's own StreamingDetector through both packages'
    stream_frames (center anchor, the tail flushed), step by step.  JAX's
    three jits bake the variables in, so they run first, after the worker's
    earlier compiles are dropped, and are dropped before the port's model is
    built.  The persistent compilation cache is off for them: writing their
    three entries took this case from 2.1 to 2.8 GB, and reading them back
    to 3.6 GB."""
    jax.clear_caches()
    trim_heap()
    variables = _variables("late-max", seed=4)
    frames = _frames(5, seed=4)
    with _no_compilation_cache():
        jstream = jstreaming.StreamingDetector(JaxYOLOv3T(num_classes=3, **_kw("late-max")), variables)
        ref = [(m, tuple(np.asarray(a) for a in dets))
               for m, dets in jstreaming.stream_frames(jstream, (jnp.asarray(f) for f in frames), anchor="center")]
        del jstream
        jax.clear_caches()
    trim_heap()
    tm = YOLOv3T(num_classes=3, **_kw("late-max"))
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    del variables
    ours = list(stream_frames(StreamingDetector(tm.eval()), (torch.from_numpy(f) for f in frames), anchor="center"))
    assert [m for m, _ in ours] == [m for m, _ in ref] == list(range(5))
    for (_, got), (_, want) in zip(ours, ref):
        assert_dets_close(got, want)


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_choice_matches_jax(name):
    """The split each configuration takes and the names of its per-frame
    half are JAX's (`_tip_split_ok`, `_embed_names`)."""
    jm = _classes(name)[0](num_classes=3, **_kw(name))
    with torch.device("meta"):
        tm = _classes(name)[1](num_classes=3, **_kw(name))
    assert streaming._tip_split_ok(tm) == jstreaming._tip_split_ok(jm) == (SPLITS[name] == "tips")
    assert streaming._embed_names(tm) == jstreaming._embed_names(jm)
    assert streaming.split_names(tm) == (jstreaming._TIP_NAMES if jstreaming._tip_split_ok(jm)
                                         else jstreaming._embed_names(jm))


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_temporal_variables_matches_jax(name):
    """`split_temporal_variables` on the port's state_dict gives the bridge
    of JAX's split of its variables, key for key, at the configuration's
    split and at the stage names."""
    jm = _classes(name)[0](num_classes=3, **_kw(name))
    shapes = _shapes(name)
    state = dict.fromkeys(_bridged_keys(shapes))
    split = jstreaming._TIP_NAMES if jstreaming._tip_split_ok(jm) else jstreaming._embed_names(jm)
    for names in (split, ("stage1", "stage2", "stage3")):
        jembed, jhead = jstreaming.split_temporal_variables(shapes, names)
        embed, head = split_temporal_variables(state, names)
        assert set(embed) == _bridged_keys(jembed) and set(head) == _bridged_keys(jhead)
        assert set(embed) | set(head) == set(state) and not set(embed) & set(head)


FEEDS = {"late-max": "tips", "t5-corr-pyramid": "stage1", "t5-funnel": "stage1", "t5-plain-tout": "routes"}


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_feed_model_holds_jax_head_variables(name):
    """A model built with `feed` holds exactly the JAX feed clone's
    variables (the bridge of JAX's head split loads with strict=True), and
    its forward on the stream's buffers equals the windowed forward; the
    pure step of `make_streaming_step` reaches the stream's buffers."""
    _, variables, tm = _models(name, seed=5)
    _, head_vars = jstreaming.split_temporal_variables(variables, streaming.split_names(tm))
    assert _bridged_keys(head_vars) == _bridged_keys(_shapes(name, FEEDS[name]))
    feed = _classes(name)[1](num_classes=3, feed=FEEDS[name], **_kw(name))
    feed.load_state_dict(flax_to_state_dict(head_vars), strict=True)
    feed.eval()
    frames = _frames(_k(name), seed=5)
    stream = StreamingDetector(tm)
    stream.reset(torch.from_numpy(frames[0]))
    for f in frames[1:]:
        stream.step(torch.from_numpy(f))
    with torch.no_grad():
        got = feed(stream._buffers if FEEDS[name] != "stage1" else stream._buffers[0])
        want = tm(torch.from_numpy(_window(frames, range(len(frames)))))
        # the pure step, buffers in and out, reaches the same buffers
        embed_fn, step_fn = streaming.make_streaming_step(tm)
        bufs = tuple(r[:, None].repeat_interleave(len(frames), 1) for r in embed_fn(torch.from_numpy(frames[0])))
        for f in frames[1:]:
            bufs, _ = step_fn(bufs, torch.from_numpy(f))
    assert_head_close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(bufs, stream._buffers))


def test_feed_arguments_raise_as_jax_asserts():
    with pytest.raises(ValueError, match="frame-pure"):
        YOLOv3T(num_classes=3, k=3, corr_pos="early", corr_d=2, k_join_pos="late", k_join_type="max", feed="tips")
    with pytest.raises(ValueError, match="plain late joins"):
        YOLOv3T(num_classes=3, k=3, k_join_type="max", k_join_pos="early", feed="tips")
    with pytest.raises(ValueError, match="feed"):
        YOLOv3T(num_classes=3, k=3, feed="routes")
    with pytest.raises(ValueError, match="plain t_out split"):
        YOLOv3Temporal(num_classes=3, corr_d=2, feed="routes")
    with pytest.raises(ValueError, match="feed='stage1'"):
        YOLOv3Temporal(num_classes=3, t_out=True, corr_d=0, feed="stage1")
    with pytest.raises(ValueError, match="feed"):
        YOLOv3Temporal(num_classes=3, feed="tips")
    with pytest.raises(ValueError, match="already a streaming head"):
        StreamingDetector(YOLOv3T(num_classes=3, k=3, k_join_type="max", k_join_pos="late", feed="tips"))
    with pytest.raises(ValueError, match="temporal window"):
        StreamingDetector(YOLOv3T(num_classes=3, k=1))
    with pytest.raises(ValueError, match="YOLOv3T and YOLOv3Temporal"):
        StreamingDetector(build_model(YoloConfig(num_classes=3)))


def test_unported_stream_cases_raise(tmp_path):
    """The conv-RNN's streams build (tests/test_torch_rnn.py) but not after
    an early correlation (a fault of the JAX forward); the int8 (item 9a)
    streams raise where the streaming detector takes their models, the
    streaming artifact (item 13) where it is asked for, and the twin's int8
    stream (item 9a)."""
    for cfg in (dict(rnn_pos="out", k_join_type="max", k_join_pos="early"),
                dict(rnn_pos="late", k_join_type="max", k_join_pos="late")):
        with torch.device("meta"):
            assert streaming.split_names(build_model(YoloConfig(
                num_classes=3, k=3, **cfg))) == (streaming._TIP_NAMES if cfg["rnn_pos"] == "out"
                                                else ("stage1", "stage2", "stage3"))
        with pytest.raises(ValueError, match="not built"):
            build_model(YoloConfig(num_classes=3, k=3, corr_pos="early", corr_d=2, **cfg))
    with torch.device("meta"):
        int8_model = YOLOv3T(num_classes=3, k=3, k_join_type="max", k_join_pos="late", quant="static")
    with pytest.raises(NotImplementedError, match="item 9a"):
        streaming.StreamingDetector(int8_model)
    for fn in (streaming.export_streaming_detector, streaming.load_streaming_detector):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn(None, None, str(tmp_path / "s"))
    base = ["--device", "cpu", "--data_shape", str(S), "--batch_size", "1", "--stream"]
    with pytest.raises(NotImplementedError, match="item 9a"):
        detect.main(base + ["--window", "3,1", "--quantize", "int8"])
    with pytest.raises(ValueError, match="temporal window"):
        detect.main(base)
    with pytest.raises(ValueError, match="stride-1"):
        detect.main(base + ["--window", "3,2"])
    with pytest.raises(ValueError, match="skip_existing"):
        detect.main(base + ["--window", "3,1", "--dataset", str(tmp_path), "--skip_existing"])


def _write_clips(root):
    """Two directories of three 120x150 JPEG frames each (the port's numpy
    JPEG writer), unique file names (the cache keys on the stem)."""
    rs = np.random.RandomState(0)
    dirs = []
    for v in range(2):
        d = root / f"vid{v}"
        d.mkdir()
        for i in range(3):
            (d / f"v{v}_{i:04d}.jpg").write_bytes(chip_smoke.encode_jpeg(rs.randint(0, 255, (120, 150, 3), np.uint8)))
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("anchor", ["trail", "center"])
def test_detect_twin_streams_per_frame(tmp_path, anchor):
    """`detect --stream` on two directories of JPEGs on the CPU: one cache
    file a frame, and the cache equal to an in-process StreamingDetector
    over the same decoded frames that resets at the second directory (a
    stream that did not reset differs there)."""
    dirs = _write_clips(tmp_path)
    args = ["--device", "cpu", "--dataset", f"{dirs[0]},{dirs[1]}", "--save_dir", str(tmp_path / "res"),
            "--save_prefix", "s", "--stream", "--stream_anchor", anchor, "--window", "3,1", "--k_join_type",
            "max", "--k_join_pos", "late", "--data_shape", str(S), "--num_workers", "1"]
    preds = detect.main(args)
    pred_dir = tmp_path / "res" / "s" / "pred"
    assert sorted(os.listdir(pred_dir)) == [f"v{v}_{i:04d}.txt" for v in range(2) for i in range(3)]
    cfg = YoloConfig(num_classes=1, k=3, k_join_type="max", k_join_pos="late")  # no classes: "object"
    stream = StreamingDetector(Detector(cfg, dtype=torch.float32, device="cpu", seed=0).model)
    paths = [sorted(str(p) for p in d.iterdir()) for d in dirs]
    frames = [torch.from_numpy(native.load_batch(p, S, S)[0])[:, None] for p in paths]

    def run(clips, names):
        out = {}
        for clip, clip_paths in zip(clips, names):
            for m, (ids, sc, bb) in stream_frames(stream, iter(clip), anchor=anchor):
                collect_boxes(out, clip_paths[m], ids[0].numpy(), sc[0].numpy(), bb[0].clamp(0, S).numpy(), S)
        return out

    want = run(frames, paths)
    assert preds == want
    assert detect.load_predictions(str(tmp_path / "res" / "s"), detect.get_dataset([str(d) for d in dirs], "")) == want
    # one stream over both directories differs at the second one's first frame
    assert run([torch.cat(frames)], [paths[0] + paths[1]])[paths[1][0]] != want[paths[1][0]]


@pytest.mark.parametrize("every", [1, 3])
def test_vid_videos_match_jax(tmp_path, every):
    """VID whole videos (`videos=True`) against the JAX dataset on the same
    tree: ids, samples, paths, sizes and stats exactly; each video's frames
    and labels (track ids kept, padded to 20 rows) bit for bit."""
    root = write_vid_tree(str(tmp_path / "vid"))
    kw = dict(splits=[(2017, "val")], videos=True, every=every, inference=True)
    ours, ref = _vid(ImageNetVidDetection, root, **kw), _vid(JaxVID, root, **kw)
    assert len(ours) == len(ref) == 3 and ours.sample_ids == ref.sample_ids == ref.get_sample_ids()
    assert ours.samples == ref.samples and ours.stats() == ref.stats()
    for i, sid in enumerate(ref.sample_ids):
        assert ours.sample_path(i) == ref.sample_path(i)
        assert ours.image_size(sid) == ref.image_size(sid)
        (clip, labels, idx), (rclip, rlabels, ridx) = ours[i], ref[i]
        assert clip.shape == rclip.shape == (12 if every == 1 else 4, 96, 128, 3)
        assert labels.shape == rlabels.shape and labels.shape[1:] == (20, 6) and idx == ridx == i
        assert np.array_equal(labels, rlabels) and np.array_equal(clip, rclip)
