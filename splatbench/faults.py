"""Faults planted underneath a run, to show that the comparison catches them:
each is a context manager that breaks the program's timed path where it
produces its result, for the length of the ``with`` block.

- ``altered``: every rendered image has one tile's pixels raised by 0.25;
- ``half_batch``: a view renders only its top half of rows (the rest left
  black), and a step's loss is the mean over the top half of the rows alone;
- ``unchanged_step``: a training step computes its loss and gradients and
  leaves the parameters as they were.
"""

from __future__ import annotations

import contextlib
import importlib


def _altered(render):
    def wrapped(scene, camera, config):
        img = render(scene, camera, config).clone()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        img[h:h + 32, w:w + 32] += 0.25
        return img
    return wrapped


def _top_half(render):
    def wrapped(scene, camera, config):
        img = render(scene, camera, config).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return wrapped


def _half_loss(img, target):
    h = img.shape[0] // 2
    return ((img[:h] - target[:h]) ** 2).mean()


@contextlib.contextmanager
def planted(name: str):
    R = importlib.import_module("splatapult_tpu_torch.render")
    T = importlib.import_module("splatapult_tpu_torch.train")
    saved = {(R, "render"): R.render, (T, "render"): T.render,
             (T, "l2_image_loss"): T.l2_image_loss, (T, "train_step"): T.train_step}
    try:
        if name == "altered":
            R.render, T.render = _altered(saved[(R, "render")]), _altered(saved[(T, "render")])
        elif name == "half_batch":
            R.render, T.l2_image_loss = _top_half(saved[(R, "render")]), _half_loss
        elif name == "unchanged_step":
            def no_update(scene, optimizer, cameras, targets, config):
                return T._batch_value_and_grad(scene, cameras, targets, config)
            T.train_step = no_update
        elif name is not None:
            raise ValueError(f"unknown fault {name!r}")
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


FAULTS = ("altered", "half_batch", "unchanged_step")
