"""The port's trainer against the JAX package's, on the CPU:

- Fast R-CNN mode (RPN off, precomputed proposals): training_losses, the
  gradients and one train_step against the JAX package's on the same
  params, batch, proposals and sampling uniforms (replayed from JAX's key
  splits), with tests/test_torch_train_step.py's tolerances;
- the CLI, `python -m detectron_tpu_torch.tools.train_net_step --device
  cpu`, on tests/test_torch_train_data.py's tiny COCO-format training set:
  2 steps give finite losses and `json_stats:` lines with the JAX step's
  keys, and a checkpoint that the JAX package's load_ckpt_params reads;
  4 steps equal 2 steps plus a --resume of 2, exactly (with torch's
  deterministic algorithms, see the fixture); --iter_size 2 is
  one train_step_accum over the loader's first two batches; with no steps
  to take, the checkpoint holds the --load_detectron tree and the ImageNet
  tree (MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS) as the JAX loaders read
  them;
- the linear-scaling rule against the JAX tool's formula
  (tools/train_net_step.py:118-130);
- TrainingStats against the JAX package's, line for line.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core.config import cfg as jax_cfg
from detectron_tpu.models import train_graph as jax_tg
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.utils import detectron_weight_helper as jax_dwh
from detectron_tpu.utils import net as jax_net
from detectron_tpu.utils import resnet_weights_helper as jax_rwh
from detectron_tpu.utils.training_stats import TrainingStats as JaxStats
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.data import loader
from detectron_tpu_torch.data import roidb as port_roidb
from detectron_tpu_torch.models import bridge, init
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.tools import train_net_step
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils.training_stats import TrainingStats
from test_torch_train_data import DATA_KEYS, FAST_RCNN_KEYS, write_train_set
from test_torch_train_step import B, G, H, W, _batch, _close_tree, \
    _replay_draws
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(4)

RP = 24  # TPU.MAX_TRAIN_PROPOSALS of the Fast R-CNN case


# ---------------------------------------------------------------------------
# Fast R-CNN mode against JAX
# ---------------------------------------------------------------------------

def _proposals():
    """RP padded proposals per image in the 64 x 64 canvas: 18 valid, near
    the gt boxes and at random, as json_dataset merges them."""
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 40, (B, RP, 2))
    props = np.concatenate([xy, xy + rng.uniform(6, 24, (B, RP, 2))], -1)
    props[:, :4] = [[5, 9, 48, 46], [28, 20, 61, 58], [2, 2, 30, 30],
                    [8, 6, 50, 40]]
    valid = np.zeros((B, RP), bool)
    valid[:, :18] = True
    props[~valid] = 0
    return props.astype(np.float32), valid


def _jax_step(params, opt_state, batch, key):
    def loss_fn(p):
        return jax_tg.training_losses(p, batch, key)

    (total, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    new_params, _, lr = jax_opt.apply_updates(params, grads, opt_state)
    return total, parts, grads, new_params, lr


def test_fast_rcnn_step_matches_jax():
    set_cfgs(mask_on=False, extra=TRAIN_KEYS + FAST_RCNN_KEYS + [
        "TPU.MAX_TRAIN_PROPOSALS", str(RP)])
    assert not cfg.RPN.RPN_ON and not jax_cfg.RPN.RPN_ON
    # jax.tree.map sorts dict keys, as the jitted step's outputs have them.
    tree = jax.tree.map(np.asarray, init.init_model(0))
    assert "rpn" not in tree
    batch = _batch(False)
    batch["proposals"], batch["prop_valid"] = _proposals()
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    total, parts, grads, new_params, lr = jax.jit(_jax_step)(
        jp, jax_opt.init_opt_state(jp), jax.tree.map(jnp.asarray, batch),
        key)

    assert port_tg.draw_sizes((H, W), G) == (0, RP + G)
    draws = _replay_draws(key, 1, RP + G)
    draws = {k: v for k, v in draws.items() if k.startswith("roi")}
    made = port_tg.make_draws(torch.Generator().manual_seed(0), B, (H, W),
                              G, "cpu")
    assert {k: tuple(v.shape) for k, v in made.items()} == {
        k: tuple(v.shape) for k, v in draws.items()}
    params = bridge.to_torch(tree, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_total, got_parts, got_grads = port_ts.loss_and_grads(params, tb,
                                                             draws)
    assert set(got_parts) == set(parts) == {"loss_cls", "loss_bbox",
                                            "accuracy_cls"}
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    assert float(parts["loss_cls"]) > 0 and float(parts["loss_bbox"]) > 0
    _close_tree(bridge.to_jax_layout(got_grads),
                jax.tree.map(np.asarray, grads), 1e-3, "grad")

    new_p, _, stats = port_ts.train_step(
        params, port_opt.init_opt_state(params), tb, draws)
    np.testing.assert_allclose(float(stats["lr"]), float(lr), rtol=1e-7)
    _close_tree(bridge.to_jax_layout(new_p),
                jax.tree.map(np.asarray, new_params), 1e-5, "params")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_net")
    # Low-contrast pixels: random weights diverge on 0-255 noise.
    write_train_set(root, contrast=4.0)
    return root


def _cli(root, out, steps, *flags, extra=()):
    """Run the CLI in this process on the tiny set: cfgs from set_cfgs
    (the trainer merges its flags into the port's cfg as it stands)."""
    set_cfgs(mask_on=True, extra=TRAIN_KEYS + DATA_KEYS + [
        "DATA_DIR", str(root), "OUTPUT_DIR", str(out),
        "TRAIN.DATASETS", "('coco_2017_train',)", "MODEL.NUM_CLASSES", "4",
        "NUM_GPUS", "1", "SOLVER.BASE_LR", "0.002",
        "SOLVER.CLIP_GRADIENTS", "10", "SOLVER.MAX_ITER", str(steps)]
        + list(extra))
    return train_net_step.main(["--bs", "2", "--nw", "2", "--device", "cpu",
                                "--disp_interval", "1"] + list(flags))


def _stats_lines(text):
    return [json.loads(line[len("json_stats: "):])
            for line in text.splitlines() if line.startswith("json_stats: ")]


def _jax_stats_keys():
    """The stats keys of the JAX step on this cfg: training_losses' parts
    (traced, not compiled), "loss" and "lr" (parallel/train_step.py:34-36),
    and TrainingStats' "iter", "time" and "eta"."""
    tree = init.init_model(0)
    parts = jax.eval_shape(jax_tg.training_losses, tree, _batch(True),
                           jax.random.PRNGKey(0))[1]
    return set(parts) | {"loss", "lr", "iter", "time", "eta"}


def test_cli_trains_logs_and_checkpoints(train_root, tmp_path, capsys):
    run = _cli(train_root, tmp_path, 2)
    lines = _stats_lines(capsys.readouterr().out)
    assert [s["iter"] for s in lines] == [0, 1]
    keys = _jax_stats_keys()
    for s in lines:
        assert set(s) == keys
        assert all(np.isfinite(v) for k, v in s.items() if k != "eta")
    assert len(run["stats"]) == 2 and len(run["loader_wait_s"]) == 2
    # The checkpoint, read by the JAX package: the trained params in the
    # JAX layout and the optimizer's step.
    assert run["ckpt"] == str(tmp_path / "default" / "ckpt" / "model_step2")
    step, payload = jax_net.load_ckpt(run["ckpt"])
    assert step == 2 and int(payload["opt_state"]["step"]) == 2
    tree = init.init_model(cfg.RNG_SEED)
    ref = jax_net.load_ckpt_params(run["ckpt"])
    assert {p for p, _ in port_opt.flatten(ref)} == \
        {p for p, _ in port_opt.flatten(tree)}
    moved = [not np.array_equal(np.asarray(a), b) for (_, a), (_, b) in zip(
        port_opt.flatten(ref), port_opt.flatten(tree))]
    assert any(moved) and not all(moved)   # frozen stages stay put


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for one test: the CPU's
    index_put_(accumulate=True), the backward of the ladder's exact
    gather, sums in a different order from run to run otherwise (as K4's
    atomics do on the card), which moves a step's body gradients by ulps."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_cli_resume_equals_an_uninterrupted_run(train_root, tmp_path,
                                                deterministic):
    full = _cli(train_root, tmp_path / "full", 4)
    half = _cli(train_root, tmp_path / "half", 2)
    rest = _cli(train_root, tmp_path / "rest", 4, "--load_ckpt",
                half["ckpt"], "--resume")
    assert rest["start_step"] == 2 and len(rest["stats"]) == 2
    assert rest["stats"] == full["stats"][2:]
    got = jax_net.load_ckpt(rest["ckpt"])
    ref = jax_net.load_ckpt(full["ckpt"])
    assert got[0] == ref[0] == 4
    for (path, a), (_, b) in zip(port_opt.flatten(got[1]),
                                 port_opt.flatten(ref[1])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_cli_deterministic_flag_holds_the_switch_for_the_steps(
        train_root, tmp_path, monkeypatch):
    """--deterministic runs every step under
    torch.use_deterministic_algorithms and gives the switch back as it
    found it."""
    seen = []
    real = port_ts.train_step

    def spy(*args):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return real(*args)

    monkeypatch.setattr(port_ts, "train_step", spy)
    run = _cli(train_root, tmp_path, 2, "--deterministic", "--no_save")
    assert seen == [True, True] and len(run["stats"]) == 2
    assert not torch.are_deterministic_algorithms_enabled()


def test_cli_iter_size_is_one_accumulated_step(train_root, tmp_path):
    run = _cli(train_root, tmp_path, 2, "--iter_size", "2", "--no_save")
    # Linear scaling: batch 2 x iter_size 2 against 1 x 2 halves MAX_ITER.
    assert cfg.SOLVER.MAX_ITER == 1 and run["ckpt"] is None
    assert len(run["stats"]) == 1 and len(run["loader_wait_s"]) == 2
    roidb, _, _ = port_roidb.combined_roidb_for_training(
        cfg.TRAIN.DATASETS, ())
    tl = loader.TrainLoader(roidb, 2, seed=cfg.RNG_SEED, num_threads=1)
    try:
        batches = [{k: torch.from_numpy(v) for k, v in next(tl).items()}
                   for _ in range(2)]
    finally:
        tl.close()
    gen = train_net_step.step_generator(0)
    draws = [port_tg.make_draws(gen, 2, tuple(b["images"].shape[1:3]),
                                b["gt_boxes"].shape[1], "cpu")
             for b in batches]
    params = bridge.to_torch(init.init_model(cfg.RNG_SEED), "cpu")
    _, _, stats = port_ts.train_step_accum(
        params, port_opt.init_opt_state(params), batches, draws)
    assert run["stats"][0] == {k: float(v) for k, v in stats.items()}


@pytest.mark.parametrize("source", ["detectron", "imagenet"])
def test_cli_starts_from_the_weights_jax_loads(train_root, tmp_path,
                                               source):
    set_cfgs(mask_on=True, extra=TRAIN_KEYS + ["MODEL.NUM_CLASSES", "4"])
    rng = np.random.RandomState(6)
    blobs = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in dwh.to_detectron_blobs(init.init_model(0)).items()}
    if source == "imagenet":
        blobs = {k: v for k, v in blobs.items()
                 if k.startswith(("conv1_", "res"))}
    pkl = str(tmp_path / "weights.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    if source == "detectron":
        run = _cli(train_root, tmp_path, 0, "--load_detectron", pkl)
        ref = jax_dwh.load_detectron_weight(init.init_model(cfg.RNG_SEED),
                                            pkl)
    else:
        run = _cli(train_root, tmp_path, 0, extra=[
            "MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS", "True",
            "RESNETS.IMAGENET_PRETRAINED_WEIGHTS", pkl])
        ref = jax_rwh.load_pretrained_imagenet_weights(
            init.init_model(cfg.RNG_SEED), pkl)
    got = dict(port_opt.flatten(jax_net.load_ckpt_params(run["ckpt"])))
    ref = dict(port_opt.flatten(ref))
    assert set(got) == set(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], np.asarray(v),
                                      err_msg=str(path))


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="A8"):
        train_net_step.main(["--multihost", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Linear scaling and TrainingStats
# ---------------------------------------------------------------------------

def _jax_tool_scaling(num_gpus, ims, base_lr, max_iter, steps, bs, iter_size):
    """tools/train_net_step.py:118-130 with one device and --bs given."""
    original_batch_size = num_gpus * ims
    step_scale = original_batch_size / (bs * iter_size)
    base_lr *= bs * iter_size / original_batch_size
    return (base_lr, int(max_iter * step_scale),
            tuple(int(s * step_scale) for s in steps))


@pytest.mark.parametrize("num_gpus,bs,iter_size", [
    (8, 2, 1), (8, 2, 4), (1, 2, 1), (8, 16, 1), (4, 3, 2)])
def test_linear_scaling_matches_the_jax_tool(num_gpus, bs, iter_size):
    set_cfgs(extra=["NUM_GPUS", str(num_gpus)])
    before = (cfg.NUM_GPUS, cfg.TRAIN.IMS_PER_BATCH, cfg.SOLVER.BASE_LR,
              cfg.SOLVER.MAX_ITER, tuple(cfg.SOLVER.STEPS))
    old = train_net_step.apply_linear_scaling(bs, iter_size)
    assert old == before[2]
    assert (cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER,
            tuple(cfg.SOLVER.STEPS)) == _jax_tool_scaling(
                *before, bs, iter_size)


def test_training_stats_print_the_jax_lines(capsys):
    set_cfgs(extra=["SOLVER.MAX_ITER", "23"])
    rng = np.random.RandomState(7)
    got, ref = TrainingStats(None, 5), JaxStats(None, 5)
    lines = {}
    for stats in (got, ref):
        stats.iter_timer.total_time, stats.iter_timer.calls = 3.7, 11
        stats.iter_timer.average_time = 3.7 / 11
    for it in range(23):
        s = {"loss_cls": rng.rand(), "loss_bbox": rng.rand() * 3,
             "accuracy_cls": rng.rand(), "loss": rng.rand() * 4,
             "lr": np.float32(0.01 * (it + 1))}
        for name, stats in (("got", got), ("ref", ref)):
            stats.UpdateIterStats(
                {k: (torch.tensor(v, dtype=torch.float64)
                     if name == "got" and k != "lr" else v)
                 for k, v in s.items()}, it)
            stats.LogIterStats(it)
            lines.setdefault(name, []).append(capsys.readouterr().out)
    assert lines["got"] == lines["ref"]
    assert sum(bool(x) for x in lines["got"]) == 6   # 0, 5, ..., 20, 22
