"""PASCAL VOC evaluation (the port's copy of
detectron_tpu/data/voc_dataset_evaluator.py; reference:
lib/datasets/voc_dataset_evaluator.py + voc_eval.py): per-class AP
with the VOC2007 11-point / VOC2010+ all-point protocols. Two ground-truth
routes, as in the reference:

1. Devkit XML (the reference's voc_eval.py :: parse_rec/voc_eval): reads
   Annotations/{id}.xml from the catalog's DEVKIT_DIR, writes the standard
   per-class results files, evaluates per the official protocol. Used
   whenever the devkit directory exists on disk.
2. COCO-converted json fallback (identical boxes + difficult flags) when no
   devkit is present.
"""

import logging
import os
import xml.etree.ElementTree as ET

import numpy as np

logger = logging.getLogger(__name__)


def voc_ap(rec, prec, use_07_metric=False):
    """Average precision from recall/precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval_class(gt_by_img, dets, ovthresh=0.5, use_07_metric=False):
    """gt_by_img: img_id -> (boxes (N,4) xyxy, difficult (N,));
    dets: list of (img_id, score, x1, y1, x2, y2)."""
    npos = 0
    marks = {}
    for img_id, (boxes, difficult) in gt_by_img.items():
        npos += int((~difficult).sum())
        marks[img_id] = np.zeros(len(boxes), bool)

    if len(dets) == 0:
        return 0.0, np.array([]), np.array([])

    dets = sorted(dets, key=lambda d: -d[1])
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, (img_id, score, x1, y1, x2, y2) in enumerate(dets):
        if img_id not in gt_by_img:
            fp[d] = 1
            continue
        boxes, difficult = gt_by_img[img_id]
        ovmax = -np.inf
        jmax = -1
        if len(boxes):
            ixmin = np.maximum(boxes[:, 0], x1)
            iymin = np.maximum(boxes[:, 1], y1)
            ixmax = np.minimum(boxes[:, 2], x2)
            iymax = np.minimum(boxes[:, 3], y2)
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((x2 - x1 + 1.0) * (y2 - y1 + 1.0)
                   + (boxes[:, 2] - boxes[:, 0] + 1.0)
                   * (boxes[:, 3] - boxes[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not difficult[jmax]:
                if not marks[img_id][jmax]:
                    tp[d] = 1
                    marks[img_id][jmax] = True
                else:
                    fp[d] = 1
        else:
            fp[d] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric), rec, prec


# ---------------------------------------------------------------------------
# Devkit-XML route (reference: lib/datasets/voc_eval.py)
# ---------------------------------------------------------------------------

def parse_rec(filename):
    """Parse a PASCAL VOC Annotations/{id}.xml file (reference:
    voc_eval.py :: parse_rec)."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "pose": getattr(obj.find("pose"), "text", ""),
            "truncated": int(getattr(obj.find("truncated"), "text", 0) or 0),
            "difficult": int(getattr(obj.find("difficult"), "text", 0) or 0),
            "bbox": [int(float(bbox.find("xmin").text)),
                     int(float(bbox.find("ymin").text)),
                     int(float(bbox.find("xmax").text)),
                     int(float(bbox.find("ymax").text))],
        })
    return objects


def voc_eval(detpath, annopath, imagesetfile, classname, ovthresh=0.5,
             use_07_metric=False):
    """Official-protocol per-class eval from devkit files (reference:
    voc_eval.py :: voc_eval, minus the pickle cache). detpath/annopath are
    format templates: detpath.format(classname), annopath.format(imagename).
    Returns (rec, prec, ap)."""
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f.readlines() if x.strip()]

    gt_by_img = {}
    for imagename in imagenames:
        recs = parse_rec(annopath.format(imagename))
        R = [obj for obj in recs if obj["name"] == classname]
        if not R:
            continue
        boxes = np.array([x["bbox"] for x in R], np.float64)
        difficult = np.array([bool(x["difficult"]) for x in R])
        gt_by_img[imagename] = (boxes, difficult)

    dets = []
    detfile = detpath.format(classname)
    if os.path.exists(detfile):
        with open(detfile) as f:
            for line in f:
                vals = line.strip().split(" ")
                if len(vals) < 6:
                    continue
                dets.append((vals[0], float(vals[1]), float(vals[2]),
                             float(vals[3]), float(vals[4]), float(vals[5])))
    ap, rec, prec = voc_eval_class(gt_by_img, dets, ovthresh=ovthresh,
                                   use_07_metric=use_07_metric)
    return rec, prec, ap


def _voc_info(dataset):
    """Devkit paths for a voc_{year}_{split} dataset name (reference:
    voc_dataset_evaluator.py :: _get_voc_results_file_template etc.)."""
    from detectron_tpu_torch.data import dataset_catalog as cat

    name = dataset.name
    year = name.split("_")[1]
    image_set = name.split("_")[2]
    devkit = cat.DATASETS[name][cat.DEVKIT_DIR]
    if hasattr(devkit, "resolve"):
        devkit = devkit.resolve()
    data_dir = os.path.join(devkit, "VOC" + year)
    return {
        "year": year,
        "image_set": image_set,
        "devkit_path": devkit,
        "anno_tmpl": os.path.join(data_dir, "Annotations", "{}.xml"),
        "imageset_file": os.path.join(data_dir, "ImageSets", "Main",
                                      image_set + ".txt"),
    }


def _write_voc_results_files(dataset, all_boxes, output_dir):
    """Standard comp4 per-class detection files: one line
    'image_id score x1 y1 x2 y2' (1-based coords, reference format)."""
    image_ids = sorted(dataset.COCO.getImgIds())
    stems = [os.path.splitext(dataset.COCO.imgs[i]["file_name"])[0]
             for i in image_ids]
    os.makedirs(output_dir, exist_ok=True)
    tmpl = os.path.join(output_dir, "comp4_det_{}_{{}}.txt".format(
        _voc_info(dataset)["image_set"]))
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__":
            continue
        with open(tmpl.format(cls), "w") as f:
            for i, stem in enumerate(stems):
                d = all_boxes[cls_ind][i]
                for row in d:
                    f.write("{} {:.6f} {:.1f} {:.1f} {:.1f} {:.1f}\n".format(
                        stem, row[4], row[0] + 1, row[1] + 1,
                        row[2] + 1, row[3] + 1))
    return tmpl


def evaluate_boxes_devkit(dataset, all_boxes, output_dir):
    """Official devkit-XML evaluation (reference voc_dataset_evaluator
    path)."""
    info = _voc_info(dataset)
    use_07 = info["year"] == "2007"
    det_tmpl = _write_voc_results_files(dataset, all_boxes, output_dir)
    aps = {}
    for cls in dataset.classes:
        if cls == "__background__":
            continue
        _, _, ap = voc_eval(det_tmpl, info["anno_tmpl"],
                            info["imageset_file"], cls,
                            use_07_metric=use_07)
        aps[cls] = ap
        logger.info("VOC AP for %s = %.4f", cls, ap)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    logger.info("VOC mAP = %.4f (devkit XML, %s metric)", mAP,
                "11-point" if use_07 else "all-point")
    return {"map": mAP, "aps": aps, "use_07_metric": use_07,
            "protocol": "devkit_xml"}


def evaluate_boxes(dataset, all_boxes, output_dir):
    """dataset: JsonDataset over a VOC-converted json; all_boxes: reference
    [cls][img] (N, 5) arrays. Returns {'map': v, 'aps': {cls: ap}}.
    Uses the official devkit-XML protocol when the devkit exists on disk;
    otherwise the COCO-converted-json route (identical gt)."""
    try:
        info = _voc_info(dataset)
        has_devkit = (os.path.exists(info["imageset_file"])
                      and os.path.isdir(os.path.dirname(
                          info["anno_tmpl"].format("x"))))
    except Exception:
        has_devkit = False
    if has_devkit:
        return evaluate_boxes_devkit(dataset, all_boxes, output_dir)
    use_07 = "voc_2007" in dataset.name
    image_ids = sorted(dataset.COCO.getImgIds())
    aps = {}
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__":
            continue
        cat_id = dataset.category_to_id_map[cls]
        gt_by_img = {}
        for img_id in image_ids:
            anns = [a for a in dataset.COCO.img_to_anns[img_id]
                    if a["category_id"] == cat_id]
            if not anns:
                continue
            boxes = np.array(
                [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2] - 1,
                  a["bbox"][1] + a["bbox"][3] - 1] for a in anns])
            difficult = np.array(
                [bool(a.get("difficult", a.get("ignore", 0)))
                 for a in anns])
            gt_by_img[img_id] = (boxes, difficult)
        dets = []
        for i, img_id in enumerate(image_ids):
            d = all_boxes[cls_ind][i]
            if len(d) == 0:
                continue
            for row in d:
                dets.append((img_id, float(row[4]), float(row[0]),
                             float(row[1]), float(row[2]), float(row[3])))
        ap, _, _ = voc_eval_class(gt_by_img, dets, use_07_metric=use_07)
        aps[cls] = ap
        logger.info("VOC AP for %s = %.4f", cls, ap)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    logger.info("VOC mAP = %.4f", mAP)
    return {"map": mAP, "aps": aps, "use_07_metric": use_07}
