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

Usage: python -m detectron_tpu_torch.tools.make_synthetic_valset \
    --out DIR [--n 192] [--split val2017]
"""

import argparse
import json
import os

import numpy as np

from detectron_tpu_torch.utils import image_io

# COCO-typical source sizes (val2017 median ~640x480, mixed aspect).
SIZES = [(480, 640), (426, 640), (640, 480), (500, 375), (612, 612),
         (375, 500), (480, 640), (427, 640)]


def make_valset(out, n, split="val2017"):
    """Write n images and their annotations under out, as the COCO split
    `split` (val2017 or train2017); returns the number of annotations."""
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
    cats = [{"id": k, "name": "c%d" % k, "supercategory": "x"}
            for k in range(1, 81)]
    gt = {"images": images, "annotations": annotations, "categories": cats}
    with open(os.path.join(ann_dir, "instances_{}.json".format(split)),
              "w") as f:
        json.dump(gt, f)
    return len(annotations)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--split", default="val2017",
                    help="val2017 (coco_2017_val) or train2017 "
                    "(coco_2017_train)")
    args = ap.parse_args(argv)
    n_ann = make_valset(args.out, args.n, args.split)
    print("wrote {} images, {} annotations under {}".format(
        args.n, n_ann, args.out))


if __name__ == "__main__":
    main()
