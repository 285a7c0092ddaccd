"""The port's parallel training step against the JAX package's sharded
steps, on the CPU: the port's ranks are gloo processes
(parallel/launch.spawn of parallel/dryrun.run_rank), the JAX side runs on
the 8 virtual CPU devices of tests/conftest.py.

The tiny training cfg (test_torch_util.TRAIN_KEYS, mask head on, 64 x 64,
a global batch of 2) on images with unequal foreground counts: image 0
holds three gt boxes, image 1 none. Both packages get the same params
(models/init.py's numpy tree), the same global batch and the same
sampling uniforms (JAX's key splits of the global batch replayed with
test_torch_train_step._replay_draws; each rank takes its rows). Checked,
with test_torch_train_step's tolerances (losses rtol 1e-4, params after
the step within 1e-5 of each leaf's largest value):
- 2 ranks (1 image each) against make_pjit_train_step(make_mesh(2));
- train_step_accum on 2 ranks, 2 microbatches, against
  make_pjit_train_step_accum(mesh, 2), with SOLVER.CLIP_GRADIENTS on;
- 4 ranks, 2 data x 2 model with the box head's fc6 / fc7 split, against
  make_pjit_train_step(make_mesh_2d(2, 2), param_shardings=
  tp_param_shardings(...)), with clipping on; the ranks' shard_params /
  gather_params round trip returns the tree exactly; the same split of
  the Xconv1fc head (fc6 alone, its columns gathered) against the port's
  one-process step;
- that the per-rank-mean recipe (each rank's own normalizers and
  TRAIN.IMS_PER_BATCH, gradients averaged) misses the bound on these
  images, and that clipping is active at the chosen norm;
- every rank logs the same (global) stats;
- tp_param_shardings' split dims against the JAX package's specs, and
  shard_params' cuts;
- dryrun_multichip(2) and (4) on the CPU build the JAX twin's spec and
  print its OK line (their ranks' results: the 1-D and 2 x 2 runs above),
  and run on cuda unless asked.
Each spawn has its own time limit (SPAWN_S); the port's ranks run while
the JAX side compiles.
"""

import concurrent.futures
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.parallel import mesh as jax_mesh
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.parallel import train_step as jax_ts
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import bridge, init
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.parallel import dryrun
from detectron_tpu_torch.parallel import launch
from detectron_tpu_torch.parallel import mesh as port_mesh
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from test_torch_train_step import G, H, W, _batch, _replay_draws
from test_torch_util import TRAIN_KEYS, jax_plain_paths, set_cfgs

torch.set_num_threads(2)

SPAWN_S = 300
RUN_RANK = "detectron_tpu_torch.parallel.dryrun:run_rank"
CLIP = ["SOLVER.CLIP_GRADIENTS", "0.5"]
# The Xconv1fc box head (one 3x3 conv, then fc6 alone): under the model
# split its fc6 columns are gathered after the ReLU.
XCONV = CLIP + ["FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_Xconv1fc_head",
                "FAST_RCNN.NUM_STACKED_CONVS", "1",
                "FAST_RCNN.CONV_HEAD_DIM", "32"]


def _unequal_batch(shift=0.0):
    """_batch(True) with every gt of image 0 and none of image 1."""
    b = _batch(True)
    b["gt_valid"][1] = False
    b["gt_boxes"][1] = 0
    b["gt_classes"][1] = 0
    b["images"] = b["images"] + np.float32(shift)
    return b


def _set(extra=()):
    set_cfgs(mask_on=True, extra=TRAIN_KEYS + list(extra))
    jax_plain_paths()


def _draws(key):
    n_anchors, n_rois = port_tg.draw_sizes((H, W), G)
    return {k: v.numpy() for k, v in _replay_draws(key, n_anchors,
                                                   n_rois).items()}


def _spawn(spec, n):
    return launch.spawn(RUN_RANK, ["cpu"] * n, (spec,), timeout_s=SPAWN_S)


def _close_params(got, ref, rel=1e-5):
    """Every leaf of got (port tree, JAX layout) within rel of the
    largest value of ref's leaf at the same path."""
    ref = dict(port_opt.flatten(jax.tree.map(np.asarray, ref)))
    got = dict(port_opt.flatten(got))
    assert set(got) == set(ref)
    worst = 0.0
    for path, r in ref.items():
        bound = rel * np.abs(r).max() + 1e-6
        err = float(np.abs(got[path] - r).max())
        worst = max(worst, err / bound)
    return worst


def _check_stats(results, ref_stats):
    for r in results[1:]:
        assert r["stats"] == results[0]["stats"]
    got = results[0]["stats"][0]
    assert set(got) == set(ref_stats) | {"lr"}
    for k, v in ref_stats.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    """Each case's port ranks (started first, in a thread; one OpenMP
    thread a rank: the suite's other workers share the cores) and its JAX
    step, compiled once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return _runs()


def _runs():
    _set()
    tree = jax.tree.map(np.asarray, init.init_model(0))
    key = jax.random.PRNGKey(1)
    batch = _unequal_batch()
    draws = _draws(key)
    micro = [_unequal_batch(), _unequal_batch(0.5)]
    micro_draws = [_draws(jax.random.fold_in(key, i)) for i in range(2)]
    out = {"tree": tree, "batch": batch, "draws": draws}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    specs = {}
    _set()
    specs["dp"] = dict(cfg=dryrun.cfg_snapshot(), tree=tree, batch=batch,
                       draws=draws, mesh=(2, 1))
    _set(CLIP)
    specs["accum"] = dict(cfg=dryrun.cfg_snapshot(), tree=tree,
                          batch=micro, draws=micro_draws, mesh=(2, 1))
    specs["tp"] = dict(cfg=dryrun.cfg_snapshot(), tree=tree, batch=batch,
                       draws=draws, mesh=(2, 2))
    _set(XCONV)
    specs["xconv"] = dict(cfg=dryrun.cfg_snapshot(),
                          tree=jax.tree.map(np.asarray, init.init_model(0)),
                          batch=batch, draws=draws, mesh=(2, 2))
    futures = {k: pool.submit(_spawn, s, s["mesh"][0] * s["mesh"][1])
               for k, s in specs.items()}

    jp = jax.tree.map(jnp.asarray, tree)
    jb = jax.tree.map(jnp.asarray, batch)
    _set()
    mesh = jax_mesh.make_mesh(2)
    with mesh:
        step = jax_ts.make_pjit_train_step(mesh, donate=False)
        out["dp"] = step(jp, jax_opt.init_opt_state(jp),
                         jax_mesh.shard_batch(mesh, jb), key)
    _set(CLIP)
    with mesh:
        step = jax_ts.make_pjit_train_step_accum(mesh, 2, donate=False)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *[jax.tree.map(jnp.asarray, b) for b in micro])
        out["accum"] = step(jp, jax_opt.init_opt_state(jp),
                            jax_mesh.shard_batch(mesh, stacked,
                                                 leading_accum=True), key)
    mesh2 = jax_mesh.make_mesh_2d(2, 2)
    with mesh2:
        sh = jax_mesh.tp_param_shardings(jp, mesh2)
        step = jax_ts.make_pjit_train_step(mesh2, donate=False,
                                           param_shardings=sh)
        out["tp"] = step(jp, jax_opt.init_opt_state(jp),
                         jax_mesh.shard_batch(mesh2, jb), key)
    for k, f in futures.items():
        out["port_" + k] = f.result()
    pool.shutdown()
    return out


def test_data_parallel_step_matches_jax(runs):
    _set()
    new_params, _, stats = runs["dp"]
    ranks = runs["port_dp"]
    _check_stats(ranks, {k: v for k, v in stats.items() if k != "lr"})
    assert float(stats["loss_mask"]) > 0
    assert _close_params(ranks[0]["params"], new_params) <= 1.0
    assert ranks[1]["params"] is None


def test_accumulating_step_matches_jax(runs):
    _set(CLIP)
    new_params, _, stats = runs["accum"]
    ranks = runs["port_accum"]
    _check_stats(ranks, {k: v for k, v in stats.items() if k != "lr"})
    assert _close_params(ranks[0]["params"], new_params) <= 1.0


def test_box_head_split_step_matches_jax(runs):
    _set(CLIP)
    new_params, _, stats = runs["tp"]
    ranks = runs["port_tp"]
    _check_stats(ranks, {k: v for k, v in stats.items() if k != "lr"})
    assert _close_params(ranks[0]["params"], new_params) <= 1.0
    assert all(r["roundtrip"] for r in ranks if r["rank"] == 0)
    # The 1-D and the 2-D meshes reach the same box loss on the same
    # images and draws.
    np.testing.assert_allclose(ranks[0]["stats"][0]["loss_cls"],
                               runs["port_dp"][0]["stats"][0]["loss_cls"],
                               rtol=1e-5)


def test_xconv_head_split_matches_one_process(runs):
    """The 2 x 2 step with the Xconv1fc head's fc6 split (its columns
    gathered after the ReLU) against the port's one-process step on both
    images (the JAX side of this split is the 2-MLP case above)."""
    _set(XCONV)
    spec = runs["port_xconv"]
    tree = jax.tree.map(np.asarray, init.init_model(0))
    assert "fc7" not in tree["box_head"]
    params = bridge.to_torch(tree, "cpu")
    new, _, stats = port_ts.train_step(
        params, port_opt.init_opt_state(params),
        {k: torch.from_numpy(v) for k, v in runs["batch"].items()},
        {k: torch.from_numpy(v) for k, v in runs["draws"].items()})
    _check_stats(spec, {k: v for k, v in stats.items() if k != "lr"})
    assert _close_params(spec[0]["params"], bridge.to_jax_layout(new)) <= 1.0
    assert spec[0]["roundtrip"]


def test_mean_of_rank_means_misses_the_bound(runs):
    """The per-rank recipe (each rank normalizes by its own counts, with
    TRAIN.IMS_PER_BATCH its own batch, and the update averages the two
    gradients) against the JAX step on the same images: the mask loss of
    image 1 (no foreground) is 0 / 1, so the mean halves image 0's."""
    _set()
    cfg.TRAIN.IMS_PER_BATCH = 1
    params = bridge.to_torch(runs["tree"], "cpu")
    grads = []
    for r in range(2):
        b = {k: torch.from_numpy(v) for k, v in port_mesh.shard_batch(
            runs["batch"], r, 2).items()}
        d = {k: torch.from_numpy(v) for k, v in port_mesh.shard_batch(
            runs["draws"], r, 2).items()}
        grads.append([g for _, g in port_opt.flatten(
            port_ts.loss_and_grads(params, b, d)[2])])
    mean = port_opt.unflatten_like(params, iter(
        [(a + b) / 2 for a, b in zip(*grads)]))
    naive, _, _ = port_opt.apply_updates(params, mean,
                                         port_opt.init_opt_state(params))
    assert _close_params(bridge.to_jax_layout(naive), runs["dp"][0]) > 10
    # The clip norm of the CLIP cases is well under the gradient's norm.
    full = port_opt.unflatten_like(params, iter(
        [a + b for a, b in zip(*grads)]))
    assert float(port_opt.global_norm(port_opt.flatten(full))) > 4 * float(
        CLIP[1])


def test_tp_param_shardings_match_jax():
    _set()
    tree = init.init_model(0)
    mesh = jax_mesh.make_mesh_2d(2, 2)
    ref = jax_mesh.tp_param_shardings(
        jax.tree.map(jnp.asarray, tree), mesh)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(ref)[0]:
        dims = [i for i, a in enumerate(sh.spec) if a == "model"]
        want[tuple(getattr(k, "key", getattr(k, "idx", None))
                   for k in path)] = dims[0] if dims else None
    got = dict(port_opt.flatten(port_mesh.tp_param_shardings(tree)))
    assert got == want
    assert {p for p, d in got.items() if d is not None} == {
        ("box_head", "fc6", "w"), ("box_head", "fc6", "b"),
        ("box_head", "fc7", "w")}


def test_shard_params_cuts_the_model_axis():
    _set()
    tree = init.init_model(0)
    for m in range(2):
        mesh = port_mesh.Mesh(2, 2, rank=2 + m, model_group=object())
        assert (mesh.data_index, mesh.model_index) == (1, m)
        got = port_mesh.shard_params(tree, mesh)
        fc6, fc7 = tree["box_head"]["fc6"], tree["box_head"]["fc7"]
        D = fc6["w"].shape[1] // 2
        np.testing.assert_array_equal(got["box_head"]["fc6"]["w"],
                                      fc6["w"][:, m * D:(m + 1) * D])
        np.testing.assert_array_equal(got["box_head"]["fc6"]["b"],
                                      fc6["b"][m * D:(m + 1) * D])
        np.testing.assert_array_equal(got["box_head"]["fc7"]["w"],
                                      fc7["w"][m * D:(m + 1) * D])
        assert got["box_head"]["fc7"]["b"] is fc7["b"]
        assert got["body"] is not None
    assert port_mesh.shard_params(tree, port_mesh.Mesh(2, 1)) is tree


def test_shard_batch_takes_the_rank_rows():
    b = _unequal_batch()
    for r in range(2):
        got = port_mesh.shard_batch(b, r, 2)
        for k, v in b.items():
            np.testing.assert_array_equal(got[k], v[r:r + 1])
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.shard_batch(b, 0, 3)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_ok(runs, n, monkeypatch, capsys):
    """dryrun_multichip(n, device="cpu") builds the JAX twin's spec (its
    mesh, n ranks on the CPU, one 128 x 128 image per data index and the
    global draws) and prints the twin's OK line from its ranks' results.
    The ranks' program is run_rank: here the fixture's 1-D (n = 2) and
    2 x 2 (n = 4) runs of it stand in for the spawn."""
    seen = []

    def spawn(target, devices, args, **kw):
        seen.append((target, devices, args[0]))
        return runs["port_dp" if n == 2 else "port_tp"]

    monkeypatch.setattr(launch, "spawn", spawn)
    assert dryrun.dryrun_multichip(n, device="cpu") is runs[
        "port_dp" if n == 2 else "port_tp"]
    (target, devices, spec), = seen
    assert target == RUN_RANK and devices == ["cpu"] * n
    assert spec["mesh"] == dryrun.mesh_shape(n) == {2: (2, 1), 4: (2, 2)}[n]
    assert spec["batch"]["images"].shape == (2, 128, 128, 3)
    assert spec["cudnn"] and spec["cfg"]["TRAIN"]["IMS_PER_BATCH"] == 2
    assert all(v.shape[0] == 2 for v in spec["draws"].values())
    mesh = "2d(data=2,model=2)" if n == 4 else "1d(data)"
    assert re.fullmatch(
        r"dryrun_multichip OK: n_devices={} mesh={} loss=[0-9.]+".format(
            n, re.escape(mesh)), capsys.readouterr().out.strip())


def test_dryrun_multichip_runs_on_cuda_unless_asked(monkeypatch):
    """Rank r on cuda:r by default: without a GPU it raises before it
    starts a process."""
    monkeypatch.setattr(launch, "spawn", None)
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun.dryrun_multichip(2)
