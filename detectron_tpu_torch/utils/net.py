"""Checkpoint I/O in the JAX package's format (the port's copy of
detectron_tpu/utils/net.py :17-82): a directory holding arrays.npz, every
leaf of the {"params": ..., "opt_state": ...} tree under its "|"-joined
path, and manifest.json with the step, the array names and free-form meta.

The trees are numpy trees in the JAX layout (models/init.init_model, or
bridge.to_jax_layout of a torch tree), so a checkpoint written by the JAX
trainer loads here and one written here loads there; bridge.to_torch then
lays the params out for torch.
"""

import json
import os

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + str(k) + "/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + str(i) + "/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_ckpt(output_dir, step, params, opt_state=None, meta=None,
              name=None):
    """Write a checkpoint to <output_dir>/ckpt/<name or model_step{step}>/
    and return that directory."""
    ckpt_dir = os.path.join(output_dir, "ckpt",
                            name or "model_step{}".format(step))
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    flat = _flatten(payload)
    manifest = {"step": int(step), "arrays": sorted(flat.keys()),
                "meta": meta or {}}
    np.savez(os.path.join(ckpt_dir, "arrays.npz"),
             **{k.replace("/", "|"): v for k, v in flat.items()})
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return ckpt_dir


def load_ckpt(ckpt_dir):
    """Returns (step, payload dict with 'params' (+ 'opt_state'))."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    return manifest["step"], _unflatten(flat)


def load_ckpt_params(ckpt_dir):
    """The numpy params tree of a checkpoint, in the JAX layout."""
    return load_ckpt(ckpt_dir)[1]["params"]
