"""Generate a synthetic COCO val set (the port's twin of
tools/make_synthetic_valset.py, with the same RandomState(0) pixels, image
sizes, boxes, polygons and categories).

Produces <out>/coco/val2017/*.ppm (noise images at COCO-typical sizes,
mixed landscape/portrait) and <out>/coco/annotations/instances_val2017.json
(coco_2017_val; with --split train2017, the same set as coco_2017_train)
with 3-5 boxes and polygon masks per image, sized so TEST.SCALE=800 /
MAX_SIZE=1333 maps them onto the 832 x 1344 canvas. Images are binary PPM,
not JPEG: utils/image_io reads PPM without OpenCV, and the JAX engine reads
the same files through cv2, so one set serves both packages.

With --keypoints it writes a person-keypoints set instead
(<out>/coco/annotations/person_keypoints_{split}.json, which the catalog
names keypoints_coco_2017_val / _train): one `person` category with the
17 COCO keypoint names, 1-4 tall person boxes (height about 2.5 x width)
per image, each with 17 keypoints inside its box, visibility 0, 1 or 2
(x = y = 0 where 0, as COCO writes them) and num_keypoints.

make_vocset writes a PASCAL VOC set in the layout the catalog names
voc_{year}_trainval / voc_{year}_test: PPM images at VOC's usual sizes
(~500 x 375) under VOC{year}/JPEGImages, the COCO-format converted jsons
under VOC{year}/annotations, and the devkit tree (Annotations/*.xml with
1-based coordinates, ImageSets/Main/{trainval,test}.txt) under
VOC{year}/VOCdevkit{year}/VOC{year}, as tests/test_voc_eval.py builds
them: 3-5 integer boxes an image of the 20 VOC classes in turn (a split
of 7 images or more holds every class), some difficult.
make_cityscapes_set writes cityscapes_fine_instanceonly_seg_{split}:
Cityscapes-sized (1024 x 2048) PPM images under cityscapes/images and
instancesonly_filtered_gtFine_{split}.json with the 8 instance classes,
polygon instances, a crowd region and an instance under 100 px an image.

Usage: python -m detectron_tpu_torch.tools.make_synthetic_valset \
    --out DIR [--n 192] [--split val2017] [--keypoints]
"""

import argparse
import json
import os

import numpy as np

from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import keypoints as keypoint_utils

# COCO-typical source sizes (val2017 median ~640x480, mixed aspect).
SIZES = [(480, 640), (426, 640), (640, 480), (500, 375), (612, 612),
         (375, 500), (480, 640), (427, 640)]


def _person(rng, ann_id, image_id, h, w):
    """One tall person box with its 17 keypoints, in COCO's format."""
    bh = rng.uniform(min(60.0, 0.5 * h), 0.9 * h)
    bw = min(bh / rng.uniform(2.0, 3.0), w - 1.0)
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    nk = len(keypoint_utils.get_keypoints()[0])
    vis = rng.choice(3, nk, p=(0.2, 0.3, 0.5))
    xs = np.where(vis > 0, x1 + rng.uniform(0, bw, nk), 0.0)
    ys = np.where(vis > 0, y1 + rng.uniform(0, bh, nk), 0.0)
    return {
        "id": ann_id, "image_id": image_id, "category_id": 1,
        "bbox": [float(x1), float(y1), float(bw), float(bh)],
        "area": float(bw * bh), "iscrowd": 0,
        "keypoints": [v for x, y, c in zip(xs, ys, vis)
                      for v in (float(x), float(y), int(c))],
        "num_keypoints": int((vis > 0).sum()),
    }


def make_valset(out, n, split="val2017", keypoints=False):
    """Write n images and their annotations under out, as the COCO split
    `split` (val2017 or train2017), a person-keypoints set with
    `keypoints`; returns the number of annotations."""
    img_dir = os.path.join(out, "coco", split)
    ann_dir = os.path.join(out, "coco", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    rng = np.random.RandomState(0)
    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        fn = "{:012d}.ppm".format(i + 1)
        image_io.write_ppm(os.path.join(img_dir, fn),
                           rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": fn})
        if keypoints:
            for _ in range(1 + i % 4):
                annotations.append(_person(rng, ann_id, i + 1, h, w))
                ann_id += 1
            continue
        for _ in range(3 + i % 3):
            bw, bh = rng.uniform(30, w / 2), rng.uniform(30, h / 2)
            x1 = rng.uniform(0, w - bw)
            y1 = rng.uniform(0, h - bh)
            annotations.append({
                "id": ann_id, "image_id": i + 1,
                "category_id": int(rng.randint(1, 81)),
                "bbox": [float(x1), float(y1), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "segmentation": [[float(x1), float(y1),
                                  float(x1 + bw), float(y1),
                                  float(x1 + bw), float(y1 + bh),
                                  float(x1), float(y1 + bh)]],
            })
            ann_id += 1
    if keypoints:
        cats = [{"id": 1, "name": "person", "supercategory": "person",
                 "keypoints": keypoint_utils.get_keypoints()[0],
                 "skeleton": []}]
        ann_fn = "person_keypoints_{}.json".format(split)
    else:
        cats = [{"id": k, "name": "c%d" % k, "supercategory": "x"}
                for k in range(1, 81)]
        ann_fn = "instances_{}.json".format(split)
    gt = {"images": images, "annotations": annotations, "categories": cats}
    with open(os.path.join(ann_dir, ann_fn), "w") as f:
        json.dump(gt, f)
    return len(annotations)


VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")
VOC_SIZES = [(375, 500), (500, 375), (333, 500), (375, 500), (500, 333)]


def make_vocset(out, n_trainval, n_test, year="2007"):
    """Write n_trainval + n_test images of a synthetic VOC{year} (image ids
    1.. in that order, file stems their 6-digit ids); returns the number
    of annotations."""
    root = os.path.join(out, "VOC" + year)
    img_dir = os.path.join(root, "JPEGImages")
    ann_dir = os.path.join(root, "annotations")
    devkit = os.path.join(root, "VOCdevkit" + year, "VOC" + year)
    for d in (img_dir, ann_dir, os.path.join(devkit, "Annotations"),
              os.path.join(devkit, "ImageSets", "Main")):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    cats = [{"id": i + 1, "name": n, "supercategory": "voc"}
            for i, n in enumerate(VOC_CLASSES)]
    n_ann = 0
    for split, ids in (("trainval", range(1, n_trainval + 1)),
                       ("test", range(n_trainval + 1,
                                      n_trainval + n_test + 1))):
        images, annotations = [], []
        for img_id in ids:
            h, w = VOC_SIZES[img_id % len(VOC_SIZES)]
            stem = "{:06d}".format(img_id)
            image_io.write_ppm(os.path.join(img_dir, stem + ".ppm"),
                               rng.randint(0, 255, (h, w, 3), np.uint8))
            images.append({"id": img_id, "width": w, "height": h,
                           "file_name": stem + ".ppm"})
            objs = []
            for _ in range(3 + img_id % 3):
                bw, bh = rng.randint(30, w // 2), rng.randint(30, h // 2)
                x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                # Every class in turn; difficult only past the first 20
                # boxes of a split, so each class has a plain instance.
                k = len(annotations)
                cls = k % len(VOC_CLASSES)
                diff = int(k >= len(VOC_CLASSES) and rng.rand() < 0.15)
                annotations.append({
                    "id": n_ann + len(annotations) + 1, "image_id": img_id,
                    "category_id": cls + 1,
                    "bbox": [x1, y1, bw, bh], "area": bw * bh,
                    "iscrowd": 0, "difficult": diff})
                objs.append(
                    "<object><name>{}</name><difficult>{}</difficult>"
                    "<bndbox><xmin>{}</xmin><ymin>{}</ymin><xmax>{}</xmax>"
                    "<ymax>{}</ymax></bndbox></object>".format(
                        VOC_CLASSES[cls], diff, x1 + 1, y1 + 1, x1 + bw,
                        y1 + bh))
            with open(os.path.join(devkit, "Annotations", stem + ".xml"),
                      "w") as f:
                f.write("<annotation><filename>{}.jpg</filename>{}"
                        "</annotation>".format(stem, "".join(objs)))
        with open(os.path.join(ann_dir, "voc_{}_{}.json".format(
                year, split)), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": cats}, f)
        with open(os.path.join(devkit, "ImageSets", "Main",
                               split + ".txt"), "w") as f:
            f.write("".join("{:06d}\n".format(i) for i in ids))
        n_ann += len(annotations)
    return n_ann


CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                      "motorcycle", "bicycle")


def _star_polygon(rng, cx, cy, r, n):
    """A star-shaped polygon of n vertices around (cx, cy), radii up to
    r."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.5 * r, r, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).reshape(-1)


def _shoelace(xy):
    x, y = xy[0::2], xy[1::2]
    return float(0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x,
                                                                        1))))


def make_cityscapes_set(out, n, split="val", size=(1024, 2048)):
    """Write n synthetic Cityscapes images (h, w = size) and their
    instance annotations: 3-7 polygon instances of the 8 classes, one crowd
    region (iscrowd 1) and one instance under 100 px an image. Returns the
    number of annotations."""
    img_dir = os.path.join(out, "cityscapes", "images")
    ann_dir = os.path.join(out, "cityscapes", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    h, w = size
    rng = np.random.RandomState(0)
    images, annotations = [], []

    def add(img_id, cls, xy, crowd):
        xy = np.clip(xy, 0, [w - 1, h - 1] * (len(xy) // 2))
        x, y = xy[0::2], xy[1::2]
        annotations.append({
            "id": len(annotations) + 1, "image_id": img_id,
            "category_id": cls + 1, "iscrowd": crowd,
            "bbox": [float(x.min()), float(y.min()),
                     float(x.max() - x.min() + 1),
                     float(y.max() - y.min() + 1)],
            "area": _shoelace(xy), "segmentation": [xy.tolist()]})

    for i in range(n):
        img_id = i + 1
        fn = "city{}_{:06d}_leftImg8bit.ppm".format(i % 3, img_id)
        image_io.write_ppm(os.path.join(img_dir, fn),
                           rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": fn})
        for _ in range(3 + i % 5):
            r = rng.uniform(30, 200)
            add(img_id, int(rng.randint(len(CITYSCAPES_CLASSES))),
                _star_polygon(rng, rng.uniform(r, w - r),
                              rng.uniform(r, h - r), r, rng.randint(5, 9)),
                0)
        add(img_id, int(rng.randint(len(CITYSCAPES_CLASSES))),
            _star_polygon(rng, rng.uniform(300, w - 300),
                          rng.uniform(300, h - 300), 250, 7), 1)
        x0, y0 = rng.randint(0, w - 8), rng.randint(0, h - 8)
        add(img_id, int(rng.randint(len(CITYSCAPES_CLASSES))),
            np.array([x0, y0, x0 + 7, y0, x0 + 7, y0 + 7, x0, y0 + 7],
                     np.float64), 0)
    cats = [{"id": i + 1, "name": c, "supercategory": "cityscapes"}
            for i, c in enumerate(CITYSCAPES_CLASSES)]
    with open(os.path.join(ann_dir, "instancesonly_filtered_gtFine_{}.json"
                           .format(split)), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    return len(annotations)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--split", default="val2017",
                    help="val2017 (coco_2017_val) or train2017 "
                    "(coco_2017_train)")
    ap.add_argument("--keypoints", action="store_true",
                    help="a person-keypoints set (keypoints_coco_2017_val "
                    "or _train)")
    args = ap.parse_args(argv)
    n_ann = make_valset(args.out, args.n, args.split, args.keypoints)
    print("wrote {} images, {} annotations under {}".format(
        args.n, n_ann, args.out))


if __name__ == "__main__":
    main()
