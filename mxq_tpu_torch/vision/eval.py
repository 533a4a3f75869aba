"""Top-1 / top-5 evaluation of the vision models (port of
``mxq_tpu/vision/eval.py``): the synthetic class-conditional set every
path is tested on, the ImageNet validation split when it is on disk, and
the evaluate loop.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def synthetic_batches(num_classes: int, image_size: int, n: int = 64,
                      batch: int = 16, seed: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Class-conditional Gaussian blobs, NHWC f32 with int labels: each
    class has a fixed mean image, so a model can score above chance and
    pruning deltas show. The draws equal ``mxq_tpu``'s (numpy's
    ``RandomState`` in the same order)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, image_size, image_size, 3).astype(
        np.float32)
    for i in range(0, n, batch):
        b = min(batch, n - i)
        labels = rng.randint(0, num_classes, size=b)
        imgs = protos[labels] + 0.5 * rng.randn(b, image_size, image_size,
                                                3).astype(np.float32)
        yield imgs, labels


def imagenet_val_batches(image_size: int, batch: int = 64,
                         max_samples: Optional[int] = None,
                         path: Optional[str] = None):
    """Normalized NHWC batches of the ImageNet-1k validation split saved
    at ``path`` (``datasets``' ``save_to_disk`` layout, ``image`` and
    ``label`` columns); None when no such directory is given or the
    ``datasets`` package is missing. Nothing is downloaded."""
    if path is None or not os.path.isdir(path):
        return None
    try:
        from datasets import load_from_disk
        ds = load_from_disk(path)
    except Exception:
        return None

    def gen():
        imgs, labels = [], []
        for seen, ex in enumerate(ds, 1):
            im = np.asarray(ex["image"].convert("RGB").resize(
                (image_size, image_size)), np.float32) / 255.0
            imgs.append((im - IMAGENET_MEAN) / IMAGENET_STD)
            labels.append(ex["label"])
            if len(imgs) == batch:
                yield np.stack(imgs), np.asarray(labels)
                imgs, labels = [], []
            if max_samples is not None and seen >= max_samples:
                break
        if imgs:
            yield np.stack(imgs), np.asarray(labels)

    return gen()


@torch.no_grad()
def evaluate(forward: Callable, params, cfg, batches) -> dict:
    """Top-1 / top-5 accuracy of ``forward(params, images, cfg)`` over an
    iterator of (images NHWC, labels), on the parameters' device."""
    top1 = top5 = n = 0
    for imgs, labels in batches:
        logits = forward(params, imgs, cfg).float().cpu().numpy()
        labels = np.asarray(labels)
        rank = np.argsort(-logits, axis=-1)
        top1 += int((rank[:, 0] == labels).sum())
        top5 += int((rank[:, :5] == labels[:, None]).any(axis=1).sum())
        n += len(labels)
    return {"acc1": top1 / max(n, 1), "acc5": top5 / max(n, 1), "n": n}
