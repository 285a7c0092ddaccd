"""Training data loader: decode, resize and pad on the host (the port's
copy of detectron_tpu/data/loader.py :32-256; reference:
lib/roi_data/loader.py and lib/roi_data/minibatch.py).

As in the JAX package, the host does no target assignment (RPN labels,
RoI sampling and mask targets are computed on the device,
models/targets.py); it only

1. reads the image (utils/image_io.imread: PPM itself, other formats
   through cv2) and flips it if the entry says so,
2. resizes it to a random TRAIN.SCALES entry with the MAX_SIZE cap,
3. zero-pads it into the static canvas of its orientation bucket,
4. pads gt boxes, classes, crowd boxes, keypoints (scaled with the
   image; with KEYPOINTS_ON) and, in Fast R-CNN mode, the entry's
   precomputed proposals to static shapes,
5. rasterizes each gt's polygons once into a (GT_MASK_SIZE)^2 crop of its
   own box (an RLE gt is decoded, cropped to its box and resized by
   image_io.resize, which follows cv2.resize's INTER_LINEAR).

Batches are aspect-grouped (all landscape or all portrait), and worker
threads prefetch them. The stream depends only on (seed, batches
consumed): one shuffle of the landscape and one of the portrait indices
per epoch, then one randint(0, 2**31 - 1) per batch that seeds the
batch's own RandomState (its scale draw); batches are delivered in ticket
order whatever thread finishes first, and start_batch fast-forwards the
stream by replaying those draws. With TPU.S2D_INPUT the images go out
as their space_to_depth blocks (utils/blob.py), as the JAX loader sends
them.
"""

import queue
import threading

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.data import rle as mask_util
from detectron_tpu_torch.utils import blob as blob_utils
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import segms as segm_utils


def load_image(entry):
    im = image_io.imread(entry["image"])
    if entry.get("flipped", False):
        im = im[:, ::-1, :]
    return im


def make_minibatch(entries, rng):
    """entries: list of roidb entries (same orientation). Returns the batch
    dict of numpy arrays that models/train_graph.training_losses takes
    (after moving each to the device)."""
    B = len(entries)
    scale_idx = rng.randint(0, len(cfg.TRAIN.SCALES))
    target_size = cfg.TRAIN.SCALES[scale_idx]
    max_size = cfg.TRAIN.MAX_SIZE
    G = cfg.TPU.MAX_GT_BOXES
    Kc = max(1, cfg.TPU.MAX_GT_BOXES // 4)
    Mg = cfg.TPU.GT_MASK_SIZE

    landscape = entries[0]["width"] >= entries[0]["height"]
    canvas = blob_utils.static_canvas(target_size, max_size, landscape)

    images = np.zeros((B,) + canvas + (3,), np.float32)
    im_info = np.zeros((B, 3), np.float32)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_classes = np.zeros((B, G), np.int32)
    gt_valid = np.zeros((B, G), bool)
    crowd_boxes = np.zeros((B, Kc, 4), np.float32)
    crowd_valid = np.zeros((B, Kc), bool)
    if cfg.MODEL.MASK_ON:
        gt_masks = np.zeros((B, G, Mg, Mg), np.float32)
    if cfg.MODEL.KEYPOINTS_ON:
        nk = cfg.KRCNN.NUM_KEYPOINTS
        gt_keypoints = np.zeros((B, G, nk, 3), np.float32)
    # Fast R-CNN mode (RPN off, TRAIN.PROPOSAL_FILES): feed the entry's
    # precomputed proposals (reference: lib/roi_data/minibatch.py ::
    # get_minibatch non-RPN branch).
    use_prop = not cfg.RPN.RPN_ON
    if use_prop:
        Rp = cfg.TPU.MAX_TRAIN_PROPOSALS
        proposals = np.zeros((B, Rp, 4), np.float32)
        prop_valid = np.zeros((B, Rp), bool)

    for i, entry in enumerate(entries):
        im = load_image(entry)
        prepped, scale = blob_utils.prep_im_for_blob(
            im, cfg.PIXEL_MEANS, target_size, max_size)
        images[i] = blob_utils.im_to_canvas(prepped, canvas)
        im_info[i] = [prepped.shape[0], prepped.shape[1], scale]

        is_crowd = entry["is_crowd"]
        gt_inds = np.where((entry["gt_classes"] > 0) & ~is_crowd)[0][:G]
        crowd_inds = np.where(is_crowd)[0][:Kc]
        n = len(gt_inds)
        gt_boxes[i, :n] = entry["boxes"][gt_inds] * scale
        gt_classes[i, :n] = entry["gt_classes"][gt_inds]
        gt_valid[i, :n] = True
        nc = len(crowd_inds)
        crowd_boxes[i, :nc] = entry["boxes"][crowd_inds] * scale
        crowd_valid[i, :nc] = True

        if use_prop:
            # Proposals are the entry boxes with gt_classes == 0 (merged
            # from the proposal file by json_dataset).
            p_inds = np.where(entry["gt_classes"] == 0)[0][:Rp]
            npr = len(p_inds)
            proposals[i, :npr] = entry["boxes"][p_inds] * scale
            prop_valid[i, :npr] = True

        if cfg.MODEL.MASK_ON:
            for j, gi in enumerate(gt_inds):
                segm = entry["segms"][gi]
                box = entry["boxes"][gi]  # unscaled coords; masks are
                # rasterized wrt the unscaled box, which is scale-invariant.
                if segm_utils.is_poly(segm) and len(segm) > 0:
                    gt_masks[i, j] = segm_utils.polys_to_mask_wrt_box(
                        segm, box, Mg)
                elif isinstance(segm, dict):
                    full = mask_util.decode(segm).astype(np.float32)
                    x1, y1, x2, y2 = [int(round(v)) for v in box]
                    crop = full[y1:y2 + 1, x1:x2 + 1]
                    if crop.size:
                        gt_masks[i, j] = image_io.resize(crop, (Mg, Mg))

        if cfg.MODEL.KEYPOINTS_ON and "gt_keypoints" in entry:
            kps = entry["gt_keypoints"][gt_inds]  # (n, 3, K)
            gt_keypoints[i, :n] = np.transpose(kps, (0, 2, 1)) * \
                np.array([scale, scale, 1.0], np.float32)

    if cfg.TPU.S2D_INPUT:
        images = blob_utils.space_to_depth(images)
    batch = {
        "images": images,
        "im_info": im_info,
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "crowd_boxes": crowd_boxes,
        "crowd_valid": crowd_valid,
    }
    if cfg.MODEL.MASK_ON:
        batch["gt_masks"] = gt_masks
    if cfg.MODEL.KEYPOINTS_ON:
        batch["gt_keypoints"] = gt_keypoints
    if use_prop:
        batch["proposals"] = proposals
        batch["prop_valid"] = prop_valid
    return batch


class TrainLoader:
    """Shuffled, aspect-grouped, prefetching minibatch iterator (replaces
    the reference's RoiDataLoader, MinibatchSampler and
    collate_minibatch). Yields make_minibatch's numpy dicts."""

    def __init__(self, roidb, batch_size, seed=None, prefetch=4,
                 num_threads=None, start_batch=0):
        self.roidb = roidb
        self.batch_size = batch_size
        self.rng = np.random.RandomState(
            cfg.RNG_SEED if seed is None else seed)
        self.num_threads = num_threads or cfg.DATA_LOADER.NUM_THREADS
        self._q = queue.Queue(maxsize=prefetch)
        self._order = None
        self._stop = threading.Event()
        self._threads = []
        self._lock = threading.Lock()
        self._cursor = 0
        self._next_ticket = 0
        self._deliver_ticket = 0
        self._reorder = {}
        self._epoch_order()
        if start_batch:
            self._fast_forward(start_batch)
        for _ in range(max(1, self.num_threads)):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _fast_forward(self, n):
        """Advance the sampler past n already-consumed batches (exact
        `--resume`): replaying the epoch shuffles and per-batch seed draws,
        without building any minibatch, reproduces the uninterrupted run's
        data order from batch n on."""
        for _ in range(n):
            if self._cursor >= len(self._order):
                self._epoch_order()
            self._cursor += 1
            self.rng.randint(0, 2**31 - 1)

    def _epoch_order(self):
        if cfg.TRAIN.ASPECT_GROUPING:
            landscape = [i for i, e in enumerate(self.roidb)
                         if e["width"] >= e["height"]]
            portrait = [i for i, e in enumerate(self.roidb)
                        if e["width"] < e["height"]]
            self.rng.shuffle(landscape)
            self.rng.shuffle(portrait)
            batches = []
            for group in (landscape, portrait):
                for s in range(0, len(group) - self.batch_size + 1,
                               self.batch_size):
                    batches.append(group[s:s + self.batch_size])
            self.rng.shuffle(batches)
            self._order = batches
        else:
            idx = np.arange(len(self.roidb))
            self.rng.shuffle(idx)
            n = (len(idx) // self.batch_size) * self.batch_size
            self._order = [list(idx[s:s + self.batch_size])
                           for s in range(0, n, self.batch_size)]
        self._cursor = 0

    def _next_batch_indices(self):
        with self._lock:
            if self._cursor >= len(self._order):
                self._epoch_order()
            batch = self._order[self._cursor]
            self._cursor += 1
            seed = int(self.rng.randint(0, 2**31 - 1))
            ticket = self._next_ticket
            self._next_ticket += 1
        return batch, seed, ticket

    def _worker(self):
        while not self._stop.is_set():
            idxs, seed, ticket = self._next_batch_indices()
            entries = [self.roidb[i] for i in idxs]
            try:
                batch = make_minibatch(entries, np.random.RandomState(seed))
            except Exception as e:  # handed to the consumer, who raises it
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((ticket, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __next__(self):
        # Deliver strictly in ticket (= sampler cursor) order, whichever
        # thread finishes first: the stream is the same for a given seed
        # at any num_threads. A worker's exception is raised here, in its
        # batch's turn.
        while self._deliver_ticket not in self._reorder:
            ticket, batch = self._q.get()
            self._reorder[ticket] = batch
        batch = self._reorder.pop(self._deliver_ticket)
        self._deliver_ticket += 1
        if isinstance(batch, Exception):
            raise RuntimeError("the loader failed to build a batch") \
                from batch
        return batch

    def __iter__(self):
        return self

    def close(self):
        """Stop the workers and wait for them (each ends after the batch
        it is building)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
