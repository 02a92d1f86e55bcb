"""Weight bridge: the reference's parameter tree, handed over as numpy
arrays, as the port's tree of tensors under the same paths.

The parity tests draw ``init_params(PRNGKey(0), cfg)`` in the reference,
convert the leaves to numpy (``np.asarray``) and call ``from_reference``;
both packages then compute the same function.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which torch cannot wrap directly: their bits
are reinterpreted through uint16, so the round trip is bit-exact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_reference(tree, device="cuda", dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: from_reference(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def to_numpy(tree):
    """The inverse for the round-trip test: tensors -> numpy arrays
    (bfloat16 leaves as uint16 bit patterns)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
