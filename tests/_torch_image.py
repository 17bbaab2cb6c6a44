"""Helpers shared by the image-model tests of the port (``test_torch_resnet``,
``test_torch_image_models``, ``test_torch_benchmark``).

Weights come from the JAX models' ``init`` and are then given random
BatchNorm parameters and statistics: the last BatchNorm of every ResNet
block starts at scale 0, and with it every residual branch adds exactly 0,
so a comparison at init would test no branch conv.  Every bias (zero at
init) is drawn too, and the heads are scaled up so logits are O(10-100)
and a relative tolerance means something.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models._convnet import variables_to_numpy

HEADS = ("head", "aux_head")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomized(variables, seed: int = 0, head_scale: float = 100.0):
    """flax ``variables`` as numpy with random BatchNorm scale U(0.5, 1.5),
    running mean N(0, 0.1) and var U(0.5, 1.5), every bias N(0, 0.1), and
    each head's kernel times ``head_scale``."""
    rng = np.random.default_rng(seed)

    def walk(tree, parent):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x, k)
                continue
            x = np.asarray(x)
            if k in ("scale", "var"):
                x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                x = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
            elif k == "kernel" and parent in HEADS:
                x = x * np.float32(head_scale)
            out[k] = x
        return out

    return {c: walk(t, c) for c, t in np_tree(variables).items()}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tree_errors(port_tree, want_tree):
    """{path: rel_err} of each leaf of a port tree (converted to flax's
    layout) against the numpy tree ``want_tree``."""
    got = variables_to_numpy(port_tree)
    out = {}

    def walk(g, w, path):
        for k, v in w.items():
            if isinstance(v, dict):
                walk(g[k], v, f"{path}/{k}")
            else:
                assert g[k].shape == np.shape(v), (path, k)
                out[f"{path}/{k}"] = rel_err(g[k], v)

    walk(got, np_tree(want_tree), "")
    return out


def as_f64(tree):
    return {k: as_f64(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}
