"""Dataset inference engine (port of detectron_tpu/core/test_engine.py;
reference: lib/core/test_engine.py :: run_inference, test_net,
initialize_model_from_cfg, empty_results, extend_results).

- Images are bucketed by orientation into static canvases, as in the JAX
  engine, and each batch of a bucket has one shape.
- The whole batch (backbone .. per-class NMS .. mask and keypoint heads)
  runs on the device through core/test.py::detect_graph, with kernels
  K1-K3; the host pastes masks and decodes keypoint heatmaps for the
  <= DETECTIONS_PER_IM survivors and fills the all_boxes structures.
- Three batches are in flight: a loader thread reads and resizes batch
  k+1, the main thread copies batch k to the device and runs it, and a
  post-processing pool pastes the masks and decodes the keypoints of
  batch k-1. detect_graph syncs
  the host inside (the ladder's torch.nonzero, the tail's overflow test),
  so unlike the JAX engine's async dispatch the device work of batch k
  ends before the paste of batch k-1 starts (ROADMAP Queue A, A2).

Entry points take the device explicitly and run on "cuda" unless the
caller asks for "cpu"; without a GPU, "cuda" raises.

On a world of W > 1 processes (torch.distributed, one per device;
parallel/mesh.py), when the batch divides by W, each rank runs its rows
[r * batch / W, (r + 1) * batch / W) of every batch, the counterpart of
the JAX engine's P("data") sharding (test_engine.py:221-238); otherwise
every rank runs every batch, as the JAX engine does. The loader thread
and the post-processing pool are each rank's own. The ranks' results are
gathered on rank 0 (gather_object) into image order; rank 0 alone writes
detections.pkl and evaluates, and the other ranks keep only their own
rows.
"""

import logging
import os
import pickle
import queue as queue_mod
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from detectron_tpu_torch.core import test as test_ops
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.data import rle as mask_util
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init
from detectron_tpu_torch.models import model_builder as mb
from detectron_tpu_torch.parallel import comm
from detectron_tpu_torch.parallel import mesh as mesh_mod
from detectron_tpu_torch.utils import blob as blob_utils
from detectron_tpu_torch.utils import boxes as box_utils
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import net as net_utils
from detectron_tpu_torch.utils.device import check_device
from detectron_tpu_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def initialize_model_from_cfg(args=None, seed=0, device="cuda"):
    """The params tree for cfg on `device`, in the compute dtype, built in
    the JAX package's order (core/test_engine.py:35-52): the numpy init of
    models/init.py from `seed`; then args.load_ckpt's params (a checkpoint
    in the JAX package's format); then args.load_detectron's blobs (a
    Detectron .pkl) over them; then the bridge to torch."""
    device = check_device(device)
    params = init.init_model(seed)
    load_ckpt = getattr(args, "load_ckpt", None) if args else None
    load_detectron = getattr(args, "load_detectron", None) if args else None
    if load_ckpt:
        params = net_utils.load_ckpt_params(load_ckpt)
    if load_detectron:
        params = dwh.load_detectron_weight(params, load_detectron)
    return bridge.to_torch(params, device, mb.compute_dtype())


def empty_results(num_classes, num_images):
    all_boxes = [[[] for _ in range(num_images)] for _ in range(num_classes)]
    all_segms = [[[] for _ in range(num_images)] for _ in range(num_classes)]
    all_keyps = [[[] for _ in range(num_images)] for _ in range(num_classes)]
    return all_boxes, all_segms, all_keyps


def extend_results(index, all_res, im_res):
    for j in range(1, len(im_res)):
        all_res[j][index] = im_res[j]


def segm_results(det_boxes, det_classes, mask_probs, im_h, im_w):
    """Paste per-detection MxM mask probabilities into the full image and
    RLE-encode (reference: lib/core/test.py :: segm_results: expand box by
    (M+2)/M, resize, binarize at MRCNN.THRESH_BINARIZE, paste)."""
    M = mask_probs.shape[1]
    scale = (M + 2.0) / M
    ref_boxes = box_utils.expand_boxes(det_boxes, scale)
    ref_boxes = ref_boxes.astype(np.int32)
    padded_mask = np.zeros((M + 2, M + 2), np.float32)
    rles = []
    for i in range(det_boxes.shape[0]):
        padded_mask[1:-1, 1:-1] = mask_probs[i]
        ref_box = ref_boxes[i]
        w = max(ref_box[2] - ref_box[0] + 1, 1)
        h = max(ref_box[3] - ref_box[1] + 1, 1)
        mask = image_io.resize(padded_mask, (w, h))
        mask = np.array(mask > cfg.MRCNN.THRESH_BINARIZE, np.uint8)
        x_0 = max(ref_box[0], 0)
        x_1 = min(ref_box[2] + 1, im_w)
        y_0 = max(ref_box[1], 0)
        y_1 = min(ref_box[3] + 1, im_h)
        # O(crop) encode: run boundaries only exist inside the crop, so the
        # full-image paste of the reference is skipped (bit-identical RLE).
        rles.append(mask_util.encode_crop(
            mask[(y_0 - ref_box[1]):(y_1 - ref_box[1]),
                 (x_0 - ref_box[0]):(x_1 - ref_box[0])],
            x_0, y_0, im_h, im_w))
    return rles


def keypoint_results(det_boxes, kps_heatmaps):
    """Decode keypoint heatmaps (D, S, S, K) on boxes (D, 4) in image
    coordinates to keypoints (D, 4, K): x, y, logit, prob (reference:
    lib/core/test.py :: keypoint_results)."""
    from detectron_tpu_torch.utils import keypoints as kp_utils

    maps = np.transpose(kps_heatmaps, (0, 3, 1, 2))
    return kp_utils.heatmaps_to_keypoints(maps, det_boxes)


def device_outputs_to_image_results(out, bi, im_info, num_classes, im_hw):
    """Convert detect_graph outputs (numpy) for image `bi` into the
    reference's per-class results (cls_boxes, cls_segms, cls_keyps), None
    for a head the model does not have. Masks are pasted into an image of
    im_hw (height, width), the original image's size. The JAX engine
    (test_engine.py:130-131) takes the scaled size over the scale,
    rounded, which misses the original by a pixel or more where the image
    was scaled down (TEST.SCALE under its short side, or past
    TEST.MAX_SIZE), and COCO's segm evaluation then fails on RLEs of two
    sizes."""
    valid = out["valid"][bi]
    boxes = out["boxes"][bi][valid]
    scores = out["scores"][bi][valid]
    classes = out["classes"][bi][valid]
    scale = float(im_info[bi][2])
    boxes_orig = boxes / scale

    cls_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    for j in range(1, num_classes):
        sel = classes == j
        cls_boxes[j] = np.hstack(
            [boxes_orig[sel], scores[sel, None]]).astype(np.float32)

    cls_segms = None
    if "mask_probs" in out:
        im_h, im_w = im_hw
        probs = out["mask_probs"][bi][valid]
        rles = segm_results(boxes_orig, classes, probs, im_h, im_w)
        cls_segms = [[] for _ in range(num_classes)]
        for r, j in zip(rles, classes):
            cls_segms[j].append(r)

    cls_keyps = None
    if "kps_heatmaps" in out:
        xy = keypoint_results(boxes_orig, out["kps_heatmaps"][bi][valid])
        cls_keyps = [[] for _ in range(num_classes)]
        for k_i, j in enumerate(classes):
            cls_keyps[j].append(xy[k_i])
    return cls_boxes, cls_segms, cls_keyps


def _flagged_host_path():
    """True when any test-time flag needs the host im_detect_all path:
    TTA, Soft-NMS, or box voting (reference: these are always applied in
    lib/core/test_engine.py :: test_net -> im_detect_all)."""
    return (cfg.TEST.BBOX_AUG.ENABLED or cfg.TEST.MASK_AUG.ENABLED
            or cfg.TEST.KPS_AUG.ENABLED or cfg.TEST.SOFT_NMS.ENABLED
            or cfg.TEST.BBOX_VOTE.ENABLED)


def _write_detections(output_dir, name, **payload):
    os.makedirs(output_dir, exist_ok=True)
    det_file = os.path.join(output_dir, name)
    with open(det_file, "wb") as f:
        pickle.dump(dict(payload, cfg=str(cfg)), f, pickle.HIGHEST_PROTOCOL)
    logger.info("Wrote detections to: %s", os.path.abspath(det_file))


def test_net_im_detect_all(params, roidb_entries, dataset, output_dir=None,
                           device="cuda"):
    """Per-image eval through core/test.py :: im_detect_all, the path that
    honors TEST.SOFT_NMS / BBOX_VOTE (reference: lib/core/test_engine.py ::
    test_net routes every image through im_detect_all)."""
    device = check_device(device)
    num_images = len(roidb_entries)
    num_classes = cfg.MODEL.NUM_CLASSES
    all_boxes, all_segms, all_keyps = empty_results(num_classes, num_images)
    timer = Timer()
    for idx, entry in enumerate(roidb_entries):
        im = image_io.imread(entry["image"])
        timer.tic()
        cls_boxes, cls_segms, cls_keyps = test_ops.im_detect_all(
            params, im, device)
        timer.toc()
        extend_results(idx, all_boxes, cls_boxes)
        if cls_segms is not None:
            extend_results(idx, all_segms, cls_segms)
        if cls_keyps is not None:
            extend_results(idx, all_keyps, cls_keyps)
        if idx % 50 == 0:
            logger.info("im_detect_all: %d/%d (%.3fs/im)", idx + 1,
                        num_images, timer.average_time)
    if output_dir and mesh_mod.is_chief():
        _write_detections(output_dir, "detections.pkl", all_boxes=all_boxes,
                          all_segms=all_segms, all_keyps=all_keyps)
    return all_boxes, all_segms, all_keyps


def test_net(params, roidb_entries, dataset, batch_size=8, output_dir=None,
             detect_fn=None, device="cuda"):
    """Run detection over a list of roidb entries. Returns all_boxes/segms/
    keyps in the reference's [cls][img] structure. detect_fn (default:
    core/test.py's detect_graph, or detect_graph_with_proposals with
    TEST.PRECOMPUTED_PROPOSALS) is called on each batch's device tensors
    (params, images, im_info[, proposals, proposal validity]).

    On a world of W ranks whose batch divides by W, each rank runs its
    rows of each batch and rank 0 gathers every rank's results and writes
    detections.pkl; the other ranks' results hold their own rows only."""
    device = check_device(device)
    if detect_fn is None and _flagged_host_path():
        return test_net_im_detect_all(params, roidb_entries, dataset,
                                      output_dir=output_dir, device=device)
    num_images = len(roidb_entries)
    num_classes = cfg.MODEL.NUM_CLASSES
    all_boxes, all_segms, all_keyps = empty_results(num_classes, num_images)

    use_props = cfg.TEST.PRECOMPUTED_PROPOSALS
    if detect_fn is None:
        detect_fn = test_ops.detect_graph_with_proposals if use_props \
            else test_ops.detect_graph

    timers = defaultdict(Timer)
    # Pre-create: im_load ticks on the loader thread; defaultdict insertion
    # is not thread-safe against the main thread's timer lookups.
    for k in ("im_load", "device_wait", "misc"):
        timers[k]

    # Bucket images by orientation to keep canvases static.
    buckets = {"landscape": [], "portrait": []}
    for idx, entry in enumerate(roidb_entries):
        key = "landscape" if entry["width"] >= entry["height"] else "portrait"
        buckets[key].append(idx)
    batches = [(key, indices[s:s + batch_size])
               for key, indices in buckets.items()
               for s in range(0, len(indices), batch_size)]
    rank, world = mesh_mod.rank_and_world()
    sharded = world > 1 and batch_size % world == 0
    if sharded:
        # This rank's rows of each (zero-padded) batch; a rank whose rows
        # are all padding skips the batch (the graph has no collective).
        batch_size //= world
        batches = [(key, chunk[rank * batch_size:(rank + 1) * batch_size])
                   for key, chunk in batches]
        batches = [(key, chunk) for key, chunk in batches if chunk]
    mine = []
    n_run = sum(len(chunk) for _, chunk in batches)

    R = cfg.TEST.PROPOSAL_LIMIT if use_props else 0
    # The graph's first conv casts to the compute dtype anyway, so casting
    # on the host halves the host-to-device copy in bf16 and changes no
    # value.
    in_dtype = mb.compute_dtype()

    def _prepare(key, chunk):
        """All host-side input work for one batch (decode/resize/pad)."""
        timers["im_load"].tic()
        infos, prop_boxes, prop_valid = [], [], []
        canvas = blob_utils.static_canvas(
            cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, key == "landscape")
        images_np = np.zeros((batch_size,) + tuple(canvas) + (3,),
                             np.float32)
        for i, idx in enumerate(chunk):
            entry = roidb_entries[idx]
            im = image_io.imread(entry["image"])
            prepped, scale = blob_utils.prep_im_for_blob(
                im, cfg.PIXEL_MEANS, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
            h, w = prepped.shape[:2]
            assert h <= canvas[0] and w <= canvas[1], (
                "prepped image %s exceeds static canvas %s"
                % ((h, w), tuple(canvas)))
            images_np[i, :h, :w] = prepped
            infos.append([h, w, scale])
            if use_props:
                boxes = entry["boxes"][entry["gt_classes"] == 0] * scale
                if cfg.DEDUP_BOXES > 0:
                    keep = box_utils.unique_boxes(boxes, cfg.DEDUP_BOXES)
                    boxes = boxes[keep]
                boxes = boxes[:R]
                pad = np.zeros((R, 4), np.float32)
                pad[: len(boxes)] = boxes
                prop_boxes.append(pad)
                v = np.zeros(R, bool)
                v[: len(boxes)] = True
                prop_valid.append(v)
        while len(infos) < batch_size:
            # Zero pad rows with a full-canvas im_info.
            infos.append([canvas[0], canvas[1], 1.0])
            if use_props:
                prop_boxes.append(np.zeros((R, 4), np.float32))
                prop_valid.append(np.zeros(R, bool))
        if cfg.TPU.S2D_INPUT:
            images_np = blob_utils.space_to_depth(images_np)
        images = torch.from_numpy(images_np).to(in_dtype)
        timers["im_load"].toc()
        return chunk, images, infos, prop_boxes, prop_valid

    # Three-way overlap: a loader thread does the input work for batch
    # k+1, the device computes batch k, and the host post-processes batch
    # k-1 (mask paste and keypoint decode, parallelized over the batch).
    prep_q = queue_mod.Queue(maxsize=2)
    stop = threading.Event()

    def _loader():
        try:
            for key, chunk in batches:
                if stop.is_set():
                    return
                prep_q.put(("ok", _prepare(key, chunk)))
            prep_q.put(("done", None))
        except BaseException as e:  # surface in the consumer
            prep_q.put(("err", e))

    loader = threading.Thread(target=_loader, daemon=True)
    loader.start()

    # Post-processing pool sized to the host: more threads than cores just
    # adds GIL/switching overhead to the loader thread it must overlap with.
    post_pool = ThreadPoolExecutor(
        max(1, min(int(cfg.DATA_LOADER.NUM_THREADS), os.cpu_count() or 1)))

    def _post(chunk, infos, out):
        timers["device_wait"].tic()
        out = {k: v.cpu().numpy() for k, v in out.items()}  # sync point
        timers["device_wait"].toc()
        timers["misc"].tic()

        def one(bi_idx):
            bi, idx = bi_idx
            entry = roidb_entries[idx]
            return idx, device_outputs_to_image_results(
                out, bi, infos, num_classes,
                (entry["height"], entry["width"]))

        mine.extend(post_pool.map(one, list(enumerate(chunk))))
        timers["misc"].toc()

    t_wall = Timer()
    t_wall.tic()
    n_done = 0
    n_first = 0
    t_first_done = None
    pending = None
    try:
        while True:
            tag, item = prep_q.get()
            if tag == "err":
                raise item
            if tag == "done":
                break
            chunk, images, infos, prop_boxes, prop_valid = item
            args = [images.to(device),
                    torch.tensor(infos, dtype=torch.float32, device=device)]
            if use_props:
                args += [torch.from_numpy(np.stack(prop_boxes)).to(device),
                         torch.from_numpy(np.stack(prop_valid)).to(device)]
            out = detect_fn(params, *args)
            if pending is not None:
                _post(*pending)
                if t_first_done is None:
                    # The steady rate below leaves out the first batch and
                    # its one-off costs (cuDNN plans, kernel loads).
                    t_first_done = time.time()
                    n_first = n_done
            pending = (chunk, infos, out)
            n_done += len(chunk)
            if n_done % (batch_size * 8) < batch_size:
                logger.info(
                    "test_net: %d/%d | load %.3fs, device wait %.3fs, "
                    "post %.3fs per batch", n_done, n_run,
                    timers["im_load"].average_time,
                    timers["device_wait"].average_time,
                    timers["misc"].average_time)
        if pending is not None:
            _post(*pending)
    finally:
        # On an error, release a loader blocked on the full queue.
        stop.set()
        while loader.is_alive():
            try:
                prep_q.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        loader.join()
        post_pool.shutdown()
    if sharded:
        got = comm.gather_object(mine)
        if got is not None:
            mine = [x for rows in got for x in rows]
    for idx, (cls_boxes, cls_segms, cls_keyps) in mine:
        extend_results(idx, all_boxes, cls_boxes)
        if cls_segms is not None:
            extend_results(idx, all_segms, cls_segms)
        if cls_keyps is not None:
            extend_results(idx, all_keyps, cls_keyps)
    t_wall.toc()
    if num_images:
        logger.info("test_net: %d images in %.3fs (%.3f img/s end-to-end"
                    "%s)", num_images, t_wall.total_time,
                    num_images / max(t_wall.total_time, 1e-9),
                    ", rank {} of {}, its rows of each batch".format(
                        rank, world) if sharded else "")
        if t_first_done is not None and n_run > n_first:
            steady = time.time() - t_first_done
            logger.info(
                "test_net: steady state %.3f img/s (%d images in %.3fs, "
                "first batch excluded%s)",
                (n_run - n_first) / max(steady, 1e-9), n_run - n_first,
                steady, ", this rank's" if sharded else "")
        logger.info("test_net: per batch (%d batches): load %.4fs, device "
                    "wait %.4fs, post %.4fs", len(batches),
                    timers["im_load"].average_time,
                    timers["device_wait"].average_time,
                    timers["misc"].average_time)

    if output_dir and mesh_mod.is_chief():
        _write_detections(output_dir, "detections.pkl", all_boxes=all_boxes,
                          all_segms=all_segms, all_keyps=all_keyps)
    return all_boxes, all_segms, all_keyps


def run_inference(args, dataset_name=None, output_dir=None, batch_size=8,
                  check_expected_results=False, ind_range=None,
                  device="cuda"):
    """Top-level: build model, run test_net over the dataset, evaluate.

    ind_range=(start, end): evaluate only images [start, end) and write
    detection_range_{start}_{end}.pkl without dataset evaluation (the
    reference's child-subprocess contract, lib/core/test_engine.py ::
    test_net with ind_range).

    On a world of several ranks test_net shards the batches; rank 0
    writes the files, evaluates and returns the results, the other ranks
    return None.
    """
    from detectron_tpu_torch.data import task_evaluation
    from detectron_tpu_torch.data.json_dataset import JsonDataset

    device = check_device(device)
    dataset_name = dataset_name or cfg.TEST.DATASETS[0]
    dataset = JsonDataset(dataset_name)
    proposal_file = None
    if cfg.TEST.PRECOMPUTED_PROPOSALS and cfg.TEST.PROPOSAL_FILES:
        proposal_file = cfg.TEST.PROPOSAL_FILES[0]
    roidb = dataset.get_roidb(gt=True, proposal_file=proposal_file,
                              proposal_limit=cfg.TEST.PROPOSAL_LIMIT)
    params = initialize_model_from_cfg(args, device=device)
    if ind_range is not None:
        start, end = int(ind_range[0]), int(ind_range[1])
        if not 0 <= start < end <= len(roidb):
            raise ValueError("--range {} out of bounds for {} images".format(
                ind_range, len(roidb)))
        all_boxes, all_segms, all_keyps = test_net(
            params, roidb[start:end], dataset, batch_size=batch_size,
            device=device)
        if output_dir and mesh_mod.is_chief():
            _write_detections(
                output_dir, "detection_range_{}_{}.pkl".format(start, end),
                all_boxes=all_boxes, all_segms=all_segms,
                all_keyps=all_keyps, start=start, end=end)
        logger.info("ind_range given: skipping dataset evaluation "
                    "(partial results; reference child-subprocess contract)")
        return None
    all_boxes, all_segms, all_keyps = test_net(
        params, roidb, dataset, batch_size=batch_size, output_dir=output_dir,
        device=device)
    if not mesh_mod.is_chief():
        return None
    t_eval = Timer()
    t_eval.tic()
    results = task_evaluation.evaluate_all(
        dataset, all_boxes, all_segms, all_keyps, output_dir or ".")
    logger.info("run_inference: evaluation of %d images in %.3fs",
                len(roidb), t_eval.toc())
    if check_expected_results:
        task_evaluation.check_expected_results(
            results, atol=cfg.EXPECTED_RESULTS_ATOL,
            rtol=cfg.EXPECTED_RESULTS_RTOL)
    return results
