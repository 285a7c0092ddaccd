"""COCO evaluation (COCOeval replacement; the port's copy of
detectron_tpu/data/coco_eval.py).

The COCO detection, instance-segmentation and keypoint (OKS) protocols:
greedy per-image matching over 10 IoU thresholds, area ranges, maxDets,
101-point interpolated precision, against the minimal COCO API in
data/coco_json.py (pycocotools.cocoeval.COCOeval's params, greedy matcher
with crowd semantics, computeOks, and summarize metrics).
"""

import copy
from collections import defaultdict

import numpy as np

from detectron_tpu_torch.data import rle as mask_util


class Params:
    def __init__(self, iouType="bbox"):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        if iouType in ("bbox", "segm"):
            self.maxDets = [1, 10, 100]
            self.areaRng = [[0, 1e10], [0, 32**2], [32**2, 96**2],
                            [96**2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        elif iouType == "keypoints":
            self.maxDets = [20]
            self.areaRng = [[0, 1e10], [32**2, 96**2], [96**2, 1e10]]
            self.areaRngLbl = ["all", "medium", "large"]
            self.kpt_oks_sigmas = np.array([
                0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62,
                0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0
        else:
            raise ValueError(iouType)
        self.iouType = iouType
        self.useCats = 1


def _bbox_iou_xywh(d, g, iscrowd):
    """xywh IoU, vectorized (N, K); crowd gt uses detection-area
    denominator (pycocotools maskUtils.iou bbox semantics)."""
    d = np.asarray(d, np.float64).reshape(-1, 4)
    g = np.asarray(g, np.float64).reshape(-1, 4)
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    ix = (np.minimum(d[:, None, 0] + d[:, None, 2], g[None, :, 0] + g[None, :, 2])
          - np.maximum(d[:, None, 0], g[None, :, 0]))
    iy = (np.minimum(d[:, None, 1] + d[:, None, 3], g[None, :, 1] + g[None, :, 3])
          - np.maximum(d[:, None, 1], g[None, :, 1]))
    inter = np.maximum(ix, 0.0) * np.maximum(iy, 0.0)
    darea = (d[:, 2] * d[:, 3])[:, None]
    garea = (g[:, 2] * g[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    denom = np.where(crowd, darea, darea + garea - inter)
    out = np.where(denom > 0, inter / np.maximum(denom, 1e-300), 0.0)
    return np.where(inter > 0, out, 0.0)


class COCOeval:
    def __init__(self, cocoGt, cocoDt, iouType="bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs = defaultdict(list)
        self.eval = {}
        self.stats = []
        self.ious = {}

    # ------------------------------------------------------------------
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds))
        gts = [g for g in gts if g["category_id"] in set(p.catIds)]
        dts = [d for d in dts if d["category_id"] in set(p.catIds)]
        if p.iouType == "segm":
            for ann in gts + dts:
                seg = ann["segmentation"]
                img = self.cocoGt.imgs[ann["image_id"]]
                if isinstance(seg, list):
                    rles = mask_util.frPyObjects(
                        seg, img["height"], img["width"])
                    ann["_rle"] = mask_util.merge(
                        rles if isinstance(rles, list) else [rles])
                elif isinstance(seg["counts"], (list, tuple)):
                    ann["_rle"] = mask_util.frPyObjects(
                        seg, img["height"], img["width"])
                else:
                    ann["_rle"] = seg
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if p.iouType == "keypoints":
                k = np.array(gt.get("keypoints", []))
                num_vis = int((k[2::3] > 0).sum()) if k.size else 0
                gt["ignore"] = gt["ignore"] or num_vis == 0
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    # ------------------------------------------------------------------
    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        if p.iouType == "segm":
            return mask_util.iou([d["_rle"] for d in dt],
                                 [g["_rle"] for g in gt], iscrowd)
        elif p.iouType == "bbox":
            return _bbox_iou_xywh([d["bbox"] for d in dt],
                                  [g["bbox"] for g in gt], iscrowd)
        else:
            return self.computeOks(imgId, catId)

    def computeOks(self, imgId, catId):
        p = self.params
        gts = self._gts[imgId, catId]
        dts = self._dts[imgId, catId]
        inds = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in inds][: p.maxDets[-1]]
        if len(gts) == 0 or len(dts) == 0:
            return []
        ious = np.zeros((len(dts), len(gts)))
        sigmas = p.kpt_oks_sigmas
        vars_ = (sigmas * 2) ** 2
        k = len(sigmas)
        for j, gt in enumerate(gts):
            g = np.array(gt["keypoints"])
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = int(np.count_nonzero(vg > 0))
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.array(dt["keypoints"])
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx = xd - xg
                    dy = yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx**2 + dy**2) / vars_ / (gt["area"] + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    # ------------------------------------------------------------------
    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params
        for g in gt:
            g["_ignore"] = 1 if (
                g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]
            ) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = self.ious[imgId, catId]
        if len(ious) > 0:
            ious = ious[:, gtind]

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape(1, len(dt))
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def evaluate(self):
        p = self.params
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds for catId in catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)

    # ------------------------------------------------------------------
    def accumulate(self):
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        catIds = p.catIds if p.useCats else [-1]
        I0 = len(p.imgIds)
        A0 = len(p.areaRng)
        for k in range(K):
            Nk = k * A0 * I0
            for a in range(A):
                Na = a * I0
                for m, maxDet in enumerate(p.maxDets):
                    E = [self.evalImgs[Nk + Na + i] for i in range(I0)]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = int(np.count_nonzero(gtIg == 0))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        if nd:
                            recall[t, k, a, m] = rc[-1]
                        else:
                            recall[t, k, a, m] = 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds2 = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds2):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------------
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, lbl in enumerate(p.areaRngLbl) if lbl == areaRng]
        mind = [i for i, md in enumerate(p.maxDets) if md == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        p = self.params
        if p.iouType in ("bbox", "segm"):
            md = p.maxDets[-1]
            self.stats = np.array([
                self._summarize(1, maxDets=md),
                self._summarize(1, iouThr=0.5, maxDets=md),
                self._summarize(1, iouThr=0.75, maxDets=md),
                self._summarize(1, areaRng="small", maxDets=md),
                self._summarize(1, areaRng="medium", maxDets=md),
                self._summarize(1, areaRng="large", maxDets=md),
                self._summarize(0, maxDets=p.maxDets[0]),
                self._summarize(0, maxDets=p.maxDets[1]),
                self._summarize(0, maxDets=p.maxDets[2]),
                self._summarize(0, areaRng="small", maxDets=md),
                self._summarize(0, areaRng="medium", maxDets=md),
                self._summarize(0, areaRng="large", maxDets=md),
            ])
        else:
            md = p.maxDets[-1]
            self.stats = np.array([
                self._summarize(1, maxDets=md),
                self._summarize(1, iouThr=0.5, maxDets=md),
                self._summarize(1, iouThr=0.75, maxDets=md),
                self._summarize(1, areaRng="medium", maxDets=md),
                self._summarize(1, areaRng="large", maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, iouThr=0.5, maxDets=md),
                self._summarize(0, iouThr=0.75, maxDets=md),
                self._summarize(0, areaRng="medium", maxDets=md),
                self._summarize(0, areaRng="large", maxDets=md),
            ])
        return self.stats
