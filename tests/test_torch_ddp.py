"""The port's data-parallel training in two processes on the CPU (gloo)
against the JAX package's step on the global batch.

Two ranks (tests/torch_ddp_worker.py, started here on a port held for them
and all killed as soon as one fails) each take two rows of a global batch
of four:
  * the full-width YOLOv3 with the space-to-depth stem (its BatchNorm pools
    four channel groups: `phases`) and the first three stages
    rematerialised, uint8 pixels with colour maps and mixup ratios, two
    steps: held to `jax.jit(make_train_step)` on the global batch;
  * tests/test_torch_train_options.py's options (accumulation over two
    micro-batches, frozen base, no decay on BN, smoothing, mixup, colour
    maps, warmup), two steps: each rank splits its own rows, so micro-batch
    i holds row i of both ranks, which is JAX's step on the global batch
    reordered as [r0 row0, r1 row0, r0 row1, r1 row1];
  * a YOLOv3T k=3 window step (late max join, early correlation d=2,
    cost volumes in float64 on both sides, as
    tests/test_torch_train_temporal.py takes them), one window a rank, its
    BN statistics over the B*k frames of both ranks: held to
    `jax.jit(make_train_step)` of the JAX package's YOLOv3T on the two
    windows;
  * one ConvBNLeaky3D cell in train mode against flax's on the global
    batch (output, gradients, statistics);
  * sync_flag, sync_any and the train twin's loaders (each rank's block of
    the epoch).
Then the train twin itself under `torchrun --nproc_per_node 2`.

Tolerances are tests/test_torch_train_step.py's float64 ones: losses rtol
1e-6, each updated leaf within 1e-5 of its largest update, the BN statistics
rtol 1e-5 (atol 1e-7); the two ranks' final states equal bit for bit."""
import contextlib
import fcntl
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import write_voc_tree
from test_torch_models import random_variables
from test_torch_train_step import _batch, _float, _jax_run, _jax_state, _variables
from test_torch_train_temporal import CFG as WINDOW_CFG, _float64_volumes, _jax_run as _window_jax_run
from test_torch_train_temporal import _jax_state as _window_jax_state, _variables as _window_variables
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3 import YOLOv3 as JYOLOv3
from videoyolo_tpu.parallel.multihost import process_epoch_indices as jax_epoch_indices
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ddp_worker.py"
WORLD = 2
S, C, B = 64, 4, 4  # B: the global batch
STEPS = 2
LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)
OPTIONS = dict(  # tests/test_torch_train_options.py's
    lr=dict(mode="poly", base_lr=1e-2, steps_per_epoch=2, epochs=3, warmup_epochs=1),
    no_wd_bn=True, freeze_base=True,
    step=dict(accum_steps=2, label_smooth=True, mixup=True),
)
REORDERED = [0, 2, 1, 3]  # micro-batch i = row i of each rank's two
S2D = dict(num_classes=C, s2d_stem=True, remat="stem")
CELL = dict(kernel=(3, 3, 3), stride=(1, 1, 1), padding=None)
TWIN = ["--device", "cpu", "--dataset", "voc", "--mixup", "--syncbn", "--batch_size", "4", "--data_shape", str(S),
        "--no_random_shape", "--nopretrained_cnn", "--num_workers", "2", "--log_interval", "1", "--dtype", "f32",
        "--save_prefix", "0000", "--gpus", "0,1", "--num_samples", "-1"]


# the deadlines: the ranks take about 80 s alone and 200 s beside five busy
# xdist workers; a torchrun test 15-20 s alone
RANKS_S = 600
TORCHRUN_S = 300


@contextlib.contextmanager
def held_port():
    """A free port, held for the block: bound here with SO_REUSEADDR and
    never listening, so the kernel hands it to no other process (another
    worker's ranks, gloo's connections), while the rendezvous store of the
    ranks or of torchrun, which binds with SO_REUSEADDR too, listens on it.
    A port only looked up and let go could be taken before the store binds
    it, and a rank would then wait out its deadline on another run's
    store."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return dict(env, **extra)


def _read_lines(proc) -> "queue.Queue":
    """`proc`'s output lines as a thread reads them; None at its end."""
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    return lines


def _drain(lines) -> str:
    out = []
    while (line := lines.get()) is not None:
        out.append(line)
    return "".join(out)


def _wait(procs, timeout, lines=None):
    """Every process's output (read by threads as it comes, so no pipe
    fills).  Kills them all as soon as one fails or `timeout` seconds have
    passed, so a rank left waiting on a dead peer costs nothing more; every
    one must exit 0."""
    lines = lines or [_read_lines(p) for p in procs]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [_drain(q) for q in lines]
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), f"exits {codes} (deadline {timeout} s)\n" + "\n".join(
        out[-4000:] for c, out in zip(codes, outs) if c)
    return outs


def _compiled(model, state_fn, batch, step_kw):
    """`jax.jit(make_train_step)` in float64 compiled ahead of its run for
    the shapes of `state_fn()`'s TrainState and of `batch`.  The state's
    optimizer is static in its tree, so the step takes any state with its
    own put in."""
    with jax.enable_x64(True):
        state = jax.eval_shape(state_fn)
        jb = {k: jax.ShapeDtypeStruct(a.shape, a.dtype) for k, a in _float(batch, np.float64).items()}
        compiled = jax.jit(jstep.make_train_step(model, num_classes=C, **step_kw)).lower(state, jb).compile()
    return lambda s, b: compiled(s.replace(tx=state.tx), b)


def _s2d_variables():
    model = JYOLOv3(**S2D)
    return model, jax.tree_util.tree_map(np.asarray, random_variables(model, np.zeros((1, S, S, 3), np.float32), 1))


def _state(v):
    """The port's float32 state of flax variables (the ranks load it into
    float64 models)."""
    return flax_to_state_dict(v)


def _double(state):
    return {k: t.double() for k, t in state.items() if t.is_floating_point()}


def _cell_reference(v, x, dy):
    """flax's cell on the global batch in float64: output, the vjp of
    (y * dy).sum() and the running statistics."""
    with jax.enable_x64(True):
        jm = jlayers.ConvBNLeaky3D(8, **CELL)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def f(params, x):
            return jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])

        (y, mutated), vjp = jax.vjp(f, v["params"], jnp.asarray(x))
        dparams, dx = vjp((jnp.asarray(dy), jax.tree_util.tree_map(jnp.zeros_like, mutated)))
        grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": dparams}))
        stats = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"batch_stats": mutated["batch_stats"]}))
        return np.asarray(y), np.asarray(dx), grads, stats


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """tests/test_torch_data.py's VOC tree, 24 trainval images: 6 steps an
    epoch at the global batch of 4."""
    return write_voc_tree(tmp_path_factory.mktemp("ddpvoc"), n=12)


def _once(tmp_path_factory, name, compute):
    """`compute()` once a test run: under xdist the first worker that asks
    runs it and leaves the result beside the workers' temp dirs, and the
    others wait on its lock and read it (the two ranks and JAX's references
    take about 15 GB, too much to hold in several workers at once).  A
    failure is left there too, so the others fail at once with it rather
    than each run the ranks again."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    shared = tmp_path_factory.getbasetemp().parent
    with open(shared / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        path, failed = shared / f"{name}.pt", shared / f"{name}.failed"
        if failed.exists():
            raise RuntimeError(f"{name} failed in another worker:\n{failed.read_text()}")
        if not path.exists():
            try:
                torch.save(compute(), path)
            except BaseException as e:
                failed.write_text(f"{type(e).__name__}: {e}"[-8000:])
                raise
        return torch.load(path, weights_only=False)


def _compare(result, ref_metrics, ref_state, v0):
    """A two-rank run against its reference: both runs' losses a step,
    each updated leaf's error over its largest update (the worst), and how
    far the BN statistics lie past rtol 1e-5 / atol 1e-7 (the worst;
    at most 0 within)."""
    leaf = {}
    for key, ours in result["update"].items():
        want = ref_state[key] - v0[key]
        leaf[key] = float((ours.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    stats = {key: float(((ours - ref_state[key]).abs() - (1e-7 + 1e-5 * ref_state[key].abs())).max())
             for key, ours in result["stats"].items()}
    return {"metrics": result["metrics"], "ref_metrics": ref_metrics,
            "worst_leaf": max(leaf.items(), key=lambda kv: kv[1]),
            "worst_stats": max(stats.items(), key=lambda kv: kv[1]), "stats_keys": sorted(stats),
            "backbone_update": max((float(u.abs().max()) for k, u in result["update"].items()
                                    if k.startswith("backbone.")), default=None)}


def _run_ddp(d, voc_root):
    """Writes the runs, runs the two ranks, computes the references, and
    returns what the tests hold of each."""
    s2d_model, s2d_v = _s2d_variables()
    plain_model, plain_v = _variables()
    window_model, window_v = _window_variables()
    batch = _batch(options=True, b=B)
    window = _window_batch()
    rs = np.random.RandomState(5)
    cell_x, cell_dy = rs.randn(2, 3, 6, 7, 6), rs.randn(2, 3, 6, 7, 8)
    cell_v = jax.tree_util.tree_map(np.asarray, random_variables(jlayers.ConvBNLeaky3D(8, **CELL), cell_x, seed=6))
    runs = {
        "step": dict(model="yolov3", config=S2D, state=_state(s2d_v), lr=LR, step_kw=dict(mixup=True),
                     batch=batch, steps=STEPS),
        "accum": dict(model="yolov3", config=dict(num_classes=C), state=_state(plain_v), lr=OPTIONS["lr"],
                      state_kw=dict(no_wd_bn=True, freeze_base=True), step_kw=OPTIONS["step"], batch=batch, steps=2),
        "window": dict(model="yolov3t", config=WINDOW_CFG, state=_state(window_v), lr=LR, batch=window, steps=1,
                       corr_dtype=torch.float64),
        "cell": dict(channels=(6, 8), kw=CELL, state=_state(cell_v), x=cell_x, dy=cell_dy),
        "loader": dict(argv=TWIN + ["--dataset_root", voc_root]),
    }
    torch.save(runs, d / "runs.pt")
    with held_port() as port:
        env = _env(WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(d), str(d)], cwd=REPO,
                                  env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(WORLD)]
        lines = [_read_lines(p) for p in procs]
        # JAX's steps compile while the ranks run, and run after them: run
        # at once, the ranks and the references would hold about 15 GB
        step_opts = dict(step=dict(mixup=True))
        try:
            with ThreadPoolExecutor(2) as pool:  # XLA compiles outside the GIL
                fns = {"step": pool.submit(_compiled, s2d_model, lambda: _jax_state(s2d_v, np.float64, step_opts),
                                           batch, step_opts["step"]),
                       "accum": pool.submit(_compiled, plain_model, lambda: _jax_state(plain_v, np.float64, OPTIONS),
                                            batch, OPTIONS["step"])}
                fns = {k: f.result() for k, f in fns.items()}
            with _float64_volumes():  # patches the JAX layers' module: after the others
                fns["window"] = _compiled(window_model, lambda: _window_jax_state(window_v, np.float64), window, {})
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        _wait(procs, RANKS_S, lines)
    refs = {
        "step": _jax_run(s2d_model, s2d_v, batch, np.float64, STEPS, step_opts, keep=(STEPS,), fn=fns["step"]),
        "accum": _jax_run(plain_model, plain_v, {k: a[REORDERED] for k, a in batch.items()}, np.float64, 2, OPTIONS,
                          keep=(2,), fn=fns["accum"]),
    }
    with _float64_volumes():
        refs["window"] = _window_jax_run(window_model, window_v, window, np.float64, 1, fn=fns["window"])
    del fns
    cell_ref = _cell_reference(cell_v, cell_x, cell_dy)
    results = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for name in ["runs.pt"] + [f"rank{r}.pt" for r in range(WORLD)]:
        os.remove(d / name)  # the models' states: about 1.5 GB
    out = {name: {**_compare(results[0][name], [m for _, m in refs[name]], refs[name][-1][0],
                             _double(runs[name]["state"])),
                  "rank_diff": [r[name]["rank_diff"] for r in results]}
           for name in ("step", "accum", "window")}
    out["cell"] = {"ranks": [r["cell"] for r in results], "ref": cell_ref}
    out["agreement"] = [{k: r[k] for k in ("world", "coordinator", "flag", "flag_not0", "any", "any_none", "loader")}
                        for r in results]
    return out


@pytest.fixture(scope="module")
def ddp(tmp_path_factory, voc_root):
    """What the tests hold of the two ranks' runs, computed once a test run."""
    return _once(tmp_path_factory, "torch_ddp", lambda: _run_ddp(tmp_path_factory.mktemp("ddp"), voc_root))


def _window_batch():
    """Two windows of 3 neighbouring frames, one colour map each (powers of
    two), the key frames' boxes."""
    rs = np.random.RandomState(2)
    k, m = WINDOW_CFG["k"], 6
    clip = rs.randint(0, 256, (2 + k - 1, S, S, 3)).astype(np.uint8)
    gtb, gti = np.full((2, m, 4), -1, np.float32), np.full((2, m, 1), -1, np.float32)
    gtb[0, :2], gti[0, :2, 0] = [[5, 6, 40, 50], [20, 2, 60, 30]], [1, 3]
    gtb[1, 0], gti[1, 0, 0] = [0, 0, 63, 63], 2
    color = np.concatenate([np.eye(3) * 2.0**-6 + np.roll(np.eye(3), 1, 1) * 2.0**-10, np.full((3, 1), -2.0)], -1)
    return {"image": np.stack([clip[i:i + k] for i in range(2)]),
            "color": np.broadcast_to(color, (2, 3, 4)).astype(np.float32), "gt_boxes": gtb, "gt_ids": gti}


def _assert_run_matches(run):
    """Losses a step (rtol 1e-6), each updated leaf within 1e-5 of its
    largest update, the BN statistics within rtol 1e-5 / atol 1e-7, and
    the two ranks' states equal."""
    assert len(run["metrics"]) == len(run["ref_metrics"])
    for om, rm in zip(run["metrics"], run["ref_metrics"]):
        assert set(om) == set(rm) == {"obj", "center", "scale", "cls", "total"}
        for key in rm:
            np.testing.assert_allclose(om[key], rm[key], rtol=1e-6, err_msg=key)
    assert run["worst_leaf"][1] < 1e-5, run["worst_leaf"]
    assert run["worst_stats"][1] <= 0, run["worst_stats"]
    assert run["rank_diff"] == [0.0, 0.0]


@pytest.mark.parametrize("run", ["step", "accum"])
def test_ddp_step_matches_jax_on_the_global_batch(ddp, run):
    """Two ranks of local B=2 against JAX's step on the global batch of 4
    (`accum`: reordered, the frozen base unmoved); the ranks end equal."""
    _assert_run_matches(ddp[run])
    if run == "accum":
        assert ddp[run]["backbone_update"] == 0
    else:  # the s2d stem's BN pools its four phases over both ranks
        assert "backbone.conv0.BatchNorm_0.running_var" in ddp[run]["stats_keys"]


def test_ddp_window_step_matches_one_process(ddp):
    """YOLOv3T windows of 3 frames, one a rank: the BN statistics span the
    2 x 3 frames of both ranks, time folded into the batch, as JAX's step
    on both windows in one process."""
    _assert_run_matches(ddp["window"])


def test_ddp_conv_bn_leaky_3d_cell_matches_flax(ddp):
    """One ConvBNLeaky3D cell in train mode, a window a rank: each rank's
    output and input gradient are its rows of flax's on the global batch,
    the averaged parameter gradients flax's over the ranks, the running
    statistics flax's."""
    y, dx, grads, stats = ddp["cell"]["ref"]
    for r, out in enumerate(ddp["cell"]["ranks"]):
        np.testing.assert_allclose(out["y"].numpy(), y[r:r + 1], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(out["dx"].numpy(), dx[r:r + 1], rtol=1e-10, atol=1e-12)
        for key, g in out["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[key].numpy() / WORLD, rtol=1e-10, atol=1e-12, err_msg=key)
        for key, t in out["stats"].items():
            np.testing.assert_allclose(t.numpy(), stats[key].numpy(), rtol=1e-10, atol=1e-12, err_msg=key)


def test_sync_flags_and_loaders_across_two_ranks(ddp):
    """sync_flag gives rank 0's value and sync_any any rank's; each rank of
    the train twin's loaders takes the local batch of 2 from its block of
    the epoch's permutation (JAX's process_epoch_indices): disjoint, the
    epoch covered, the blocks new each epoch."""
    ranks = ddp["agreement"]
    assert [r["world"] for r in ranks] == [WORLD, WORLD]
    assert [r["coordinator"] for r in ranks] == [True, False]
    assert all(r["flag"] and not r["flag_not0"] and r["any"] and not r["any_none"] for r in ranks)
    loaders = [r["loader"] for r in ranks]
    assert all(lo["batch_size"] == (2, 2) and lo["steps"] == 6 for lo in loaders)
    for epoch in range(2):
        blocks = [sum(lo["epochs"][epoch], []) for lo in loaders]
        for r, block in enumerate(blocks):
            assert block == jax_epoch_indices(24, epoch, seed=233, process_index=r, process_count=WORLD).tolist()
        assert not set(blocks[0]) & set(blocks[1]) and sorted(blocks[0] + blocks[1]) == list(range(24))
    assert loaders[0]["epochs"][0] != loaders[0]["epochs"][1]


def _torchrun(port, voc_root, exp, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD), "--master_port",
           str(port), "-m", "videoyolo_torch.train_yolov3", *TWIN, "--dataset_root", voc_root,
           "--experiment_root", str(exp), *extra]
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_torchrun_twin_one_epoch_checkpoint_read_by_jax(voc_root, tmp_path):
    """`torchrun --nproc_per_node 2 -m videoyolo_torch.train_yolov3 --device
    cpu --dataset voc --mixup --syncbn`: one epoch of 6 steps at the global
    batch of 4, both ranks validating; one checkpoint and one _train.log,
    rank 0's; the JAX package reads the checkpoint into its YOLOv3."""
    exp = tmp_path / "exp"
    with held_port() as port:
        out, = _wait([_torchrun(port, voc_root, exp, "--epochs", "1", "--save_interval", "1")], TORCHRUN_S)
    assert out.count("[Epoch 0][Batch 5]") == WORLD and out.count("[Epoch 0] Validation") == WORLD
    assert "[Epoch 0][Batch 6]" not in out
    files = sorted(os.listdir(exp / "0000"))
    assert files == ["yolo3_darknet53_voc_0000.params", "yolo3_darknet53_voc_train.log"], files
    try:
        model = JYOLOv3(num_classes=20)
        shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0), np.zeros((1, S, S, 3)))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        loaded = jckpt.load_variables(str(exp / "0000" / files[0]), template)
        leaves = jax.tree_util.tree_leaves(loaded)
        assert len(leaves) == len(jax.tree_util.tree_leaves(template))
        assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
    finally:
        os.remove(exp / "0000" / files[0])  # 245 MB


def _children(pid):
    return [int(p) for p in subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)], capture_output=True,
                                           text=True).stdout.split()]


def _rank_pid(agent, rank):
    """The pid of the worker of `rank` that torchrun's agent started."""
    for pid in _children(agent.pid):
        try:
            env = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
        except FileNotFoundError:
            continue
        if f"RANK={rank}".encode() in env:
            return pid
    return None


def test_torchrun_twin_sigterm_to_one_rank_stops_both(voc_root, tmp_path):
    """A SIGTERM to rank 1 mid-epoch: both ranks agree at the next
    log-interval boundary, rank 0 writes `<prefix>_0000.params` (no
    validation, no other checkpoint) and every process exits 0."""
    exp = tmp_path / "exp"
    with held_port() as port:
        agent = _torchrun(port, voc_root, exp, "--epochs", "3", "--save_interval", "1")
        reader, lines = _read_lines(agent), []
        try:
            deadline = time.monotonic() + TORCHRUN_S
            while (left := deadline - time.monotonic()) > 0:
                try:
                    line = reader.get(timeout=left)
                except queue.Empty:
                    break
                if line is None:
                    reader.put(None)  # the end, for _wait's read
                    break
                lines.append(line)
                if "[Epoch 0][Batch 0]" in line:
                    os.kill(_rank_pid(agent, 1), signal.SIGTERM)
                    break
            rest, = _wait([agent], TORCHRUN_S, [reader])
        finally:
            if agent.poll() is None:
                agent.kill()
    out = "".join(lines) + rest
    assert out.count("Preempted: wrote") == WORLD and "Validation" not in out, out[-4000:]
    assert "[Epoch 1]" not in out
    files = sorted(os.listdir(exp / "0000"))
    assert files == ["yolo3_darknet53_voc_0000.params", "yolo3_darknet53_voc_train.log"], files
    os.remove(exp / "0000" / files[0])
