"""The loops over the port's entry points, one module each, named by a
traffic file's ``driver``: ``infer_packed`` (packed forwards fed by the
port's data layer), ``train_mlm`` (masked-LM steps), ``score_mask_margin``
(variant scoring, one protein at a time). A new kind of loop is a new
module here; a new mix of an existing kind is only a traffic file."""

from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f'{__name__}.{kind}').Driver
